"""Measure per-segment step time + boundary wire bytes of one model.

Runs :class:`~repro_torch.serving.profiler.SegmentProfiler` (real forward
passes through :class:`~repro_torch.serving.segments.SegmentChain`, on the
Hopper kernels) and merges the measured/analytic ratios into a
``bench-profiles/v1`` file that :class:`~repro_torch.core.profiling.
CalibratedCostModel` loads.  It writes only the file ``--out`` names
(default ``BENCH_profiles_torch.json`` in the working directory), merge-on-
write, so re-profiling one arch keeps the others.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_segments \\
      --full --param-dtype bfloat16 --batch 1 --tokens 512 --compress
  PYTHONPATH=src python -m repro_torch.launch.profile_segments --device cpu

``--full`` profiles the full-width, full-depth model (random weights from
seed 0); the default is the reduced model.  ``--device`` defaults to
cuda.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch

from repro_torch.configs import get_bundle
from repro_torch.core.profiling import SegmentProfile
from repro_torch.device import resolve_device
from repro_torch.serving import SegmentProfiler

_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full-width, full-depth model instead of the reduced one")
    ap.add_argument("--param-dtype", choices=sorted(_PARAM_DTYPES),
                    default="float32")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--compress", action="store_true",
                    help="route boundaries through the int8 kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="BENCH_profiles_torch.json", metavar="PATH")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    bundle = get_bundle(args.arch, reduced=not args.full)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                         _PARAM_DTYPES[args.param_dtype])
    t0 = time.perf_counter()
    mp = SegmentProfiler(bundle, params, batch=args.batch, tokens=args.tokens,
                         reps=args.reps, compress=args.compress).profile()
    print(f"{args.arch} on {dev}: units={mp.graph_units} "
          f"compute_scale={mp.compute_scale:.3f} "
          f"transfer_scale={mp.transfer_scale:.3f} "
          f"({time.perf_counter() - t0:.1f}s)")
    for s in mp.segments:
        print(f"  [{s.lo:3d},{s.hi:3d}) {s.step_time_s * 1e3:8.3f} ms "
              f"ratio={s.time_ratio:7.3f} wire={s.boundary_bytes_tok:8.1f} B/tok")
    out = pathlib.Path(args.out)
    doc = SegmentProfile({args.arch: mp}).save(out, refreshed=[args.arch])
    print(f"wrote {out} ({len(doc['models'])} models)")
    return doc


if __name__ == "__main__":
    main()
