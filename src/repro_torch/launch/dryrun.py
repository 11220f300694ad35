"""Dry-run: count every (arch × shape × mesh) cell's step on ``meta`` tensors.

The reference's ``launch/dryrun.py`` lowers and compiles each cell for 512
placeholder devices and reads XLA's cost analysis.  The port counts instead:
for each cell it

  1. builds the FULL-size config's params and inputs on the ``meta`` device
     (``bundle.param_specs``, ``bundle.input_specs``: shapes and dtypes, no
     allocation — command-r-plus-104b included),
  2. runs the step: ``make_train_step``'s step (loss, ``torch.autograd.grad``,
     AdamW) for ``train``, ``bundle.prefill`` or one ``bundle.decode`` step
     (at the cache's last position) for the serving shapes,
  3. counts its operations (``FlopCounterMode`` over the aten ops, plus each
     kernel's own count from its ``meta`` branch, ``kernels/cost.py``) and its
     bytes (every aten op's operands and results: eager PyTorch does not
     fuse, so that is its traffic; plus each kernel's),
  4. sizes each device's state by the sharding policy at the production mesh
     (params, AdamW ``mu``/``nu`` and the residual for train, bf16 TP-only
     params for serving, inputs and caches; activations are not counted),
  5. writes ``experiments/dryrun_torch/{arch}__{shape}__{mesh}.json`` with the
     roofline terms at the H100's data-sheet rates.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, LONG_CONTEXT_ARCHS, get_bundle
from repro_torch.distributed.sharding import (
    cache_pspecs,
    dp_axes,
    input_pspecs,
    param_pspecs,
    shard_shape,
)
from repro_torch.kernels import cost
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.api import SHAPES
from repro_torch.models.common import tree_flatten
from repro_torch.training.train_step import (
    TrainStepConfig,
    make_train_step,
    serving_pspecs,
)

# ---------------------------------------------------------------- hardware --
HARDWARE = "NVIDIA H100 SXM (data sheet, 700 W)"
PEAK_FLOPS = 989.4e12        # bf16 dense, a card
HBM_BW = 3.35e12             # HBM3 bytes/s, a card
COLLECTIVE_NOTE = ("null: tensor-parallel execution is not ported, so the "
                   "'model' axis's collectives are not counted, and no link "
                   "rate between the production mesh's cards is given")

# aten ops that move no bytes: allocations and aliases
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.detach.default,
         torch.ops.aten.alias.default, torch.ops.aten.lift_fresh.default,
         torch.ops.aten._unsafe_view.default}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCount(TorchDispatchMode):
    """Sums each aten op's operand and result bytes (views and allocations
    move none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _FREE and not func.is_view:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def model_flops(bundle, shape) -> float:
    """The reference's useful-work count: 6·N·tokens to train, 2·N·tokens to
    serve (N: active params)."""
    n_active = bundle.num_active_params()
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        return 6.0 * n_active * s * b
    if shape.kind == "prefill":
        return 2.0 * n_active * s * b
    return 2.0 * n_active * b        # decode: one token / sequence


def _per_device_bytes(tensors, specs, sizes) -> int:
    """Bytes one device holds of a tree under its spec tree."""
    leaves = tree_flatten(tensors)[0]
    flat_specs = []
    _spec_leaves(specs, flat_specs)
    return sum(math.prod(shard_shape(tuple(t.shape), sp, sizes)) * t.element_size()
               for t, sp in zip(leaves, flat_specs))


def _spec_leaves(specs, out: list) -> None:
    """A spec tree's specs in ``tree_flatten``'s order (dict keys sorted)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            _spec_leaves(specs[k], out)
    elif isinstance(specs, list):
        for sp in specs:
            _spec_leaves(sp, out)
    else:
        out.append(specs)


def count_step(bundle, shape) -> dict:
    """Runs ``shape``'s step of ``bundle`` on ``meta`` tensors and counts it:
    {"aten": {ops, bytes}, "kernels": {name: {calls, ops, bytes}}, "ops",
    "bytes", and the inputs and state it ran on}."""
    ispecs = bundle.input_specs(shape)
    if shape.kind == "train":
        step_fn, init_state = make_train_step(bundle, TrainStepConfig(), "meta")
        state = init_state(params=bundle.param_specs(torch.float32))
    else:
        params = bundle.param_specs(torch.bfloat16)
    with cost.kernel_tally() as kernels, FlopCounterMode(display=False) as flops, \
            ByteCount() as traffic:
        if shape.kind == "train":
            step_fn(state, ispecs)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    _, cache = bundle.prefill(params, ispecs)
                else:
                    bundle.decode(params, ispecs["cache"], ispecs["tokens"],
                                  shape.seq_len - 1)
    aten = {"ops": float(flops.get_total_flops()), "bytes": float(traffic.bytes)}
    out = {"aten": aten, "kernels": kernels,
           "ops": aten["ops"] + sum(k["ops"] for k in kernels.values()),
           "bytes": aten["bytes"] + sum(k["bytes"] for k in kernels.values()),
           "inputs": ispecs}
    if shape.kind == "train":
        out["state"] = state
    else:
        out["params"] = params
        if shape.kind == "prefill":
            out["cache"] = cache
    return out


def memory_per_device(bundle, shape, counted: dict, sizes: dict) -> dict:
    """Bytes one device holds at the production mesh ``sizes``, by the
    policy's specs: state (train) or bf16 TP-only params (serving), inputs,
    caches.  Activations and temporaries are not counted."""
    fam = bundle.family
    ispecs = counted["inputs"]
    in_sh = input_pspecs(ispecs, sizes, family=fam)
    inputs = {k: v for k, v in ispecs.items() if k != "cache"}
    mem = {"inputs": _per_device_bytes(inputs, {k: in_sh[k] for k in inputs},
                                       sizes)}
    if shape.kind == "train":
        state = counted["state"]
        pspecs = param_pspecs(state["params"], sizes)
        mem["params"] = _per_device_bytes(state["params"], pspecs, sizes)
        mem["opt_state"] = sum(_per_device_bytes(state["opt"][k], pspecs, sizes)
                               for k in ("mu", "nu"))
        mem["residual"] = (_per_device_bytes(state["residual"], pspecs, sizes)
                           if "residual" in state else 0)
    else:
        mem["params"] = _per_device_bytes(counted["params"],
                                          serving_pspecs(bundle, sizes), sizes)
        cache = ispecs.get("cache", counted.get("cache"))
        mem["cache"] = _per_device_bytes(
            cache, cache_pspecs(cache, sizes, family=fam), sizes)
    mem["total"] = sum(mem.values())
    return mem


def dp_allreduce_bytes(bundle, sizes: dict) -> float:
    """Bytes each device sends in the ring all-reduce of its gradient over
    the dp axes: 2 (n - 1) / n of its float32 gradient, each leaf cut by the
    policy's "model" shards only (FSDP's dp shards are what the all-reduce
    spreads)."""
    n = math.prod(sizes[a] for a in dp_axes(sizes))
    tp_only = {a: (v if a == "model" else 1) for a, v in sizes.items()}
    params = bundle.param_specs(torch.float32)
    grad = _per_device_bytes(params, param_pspecs(params, sizes), tp_only)
    return 2.0 * (n - 1) / n * grad


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path) -> dict:
    shape = SHAPES[shape_name]
    sizes = production_mesh_shape(multi_pod=(mesh_kind == "multipod"))
    n_chips = math.prod(sizes.values())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": sizes, "chips": n_chips, "status": "ok"}
    t0 = time.time()
    try:
        bundle = get_bundle(arch)
        counted = count_step(bundle, shape)
        rec["count_s"] = round(time.time() - t0, 1)
        rec["cost"] = {
            "ops": counted["ops"], "bytes": counted["bytes"],
            "ops_per_chip": counted["ops"] / n_chips,
            "bytes_per_chip": counted["bytes"] / n_chips,
            "aten": counted["aten"], "kernels": counted["kernels"],
            "collective_bytes_per_chip": (dp_allreduce_bytes(bundle, sizes)
                                          if shape.kind == "train" else 0.0),
        }
        rec["memory_per_chip"] = memory_per_device(bundle, shape, counted, sizes)
        rec["hardware"] = {"name": HARDWARE, "peak_flops": PEAK_FLOPS,
                           "hbm_bytes_per_s": HBM_BW}
        terms = {"t_compute_s": rec["cost"]["ops_per_chip"] / PEAK_FLOPS,
                 "t_memory_s": rec["cost"]["bytes_per_chip"] / HBM_BW}
        rec["roofline"] = dict(terms, t_collective_s=None,
                               t_collective_note=COLLECTIVE_NOTE,
                               bottleneck=max(terms, key=terms.get))
        mf = model_flops(bundle, shape)
        rec["model_flops"] = mf
        rec["useful_flops_ratio"] = mf / counted["ops"] if counted["ops"] else None
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def cells(archs, shapes, meshes):
    for arch in archs:
        for shape in shapes:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue  # documented skip: quadratic-attention archs
            for mesh in meshes:
                yield arch, shape, mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    for arch, shape, mesh in cells(archs, shapes, meshes):
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") == "ok":
                print(f"[skip] {arch} {shape} {mesh}")
                continue
        t0 = time.time()
        rec = run_cell(arch, shape, mesh, out_dir)
        if rec["status"] == "ok":
            r = rec["roofline"]
            extra = (f" compute={r['t_compute_s']:.3f}s mem={r['t_memory_s']:.3f}s"
                     f" -> {r['bottleneck']}; model/counted ops "
                     f"{rec['useful_flops_ratio']:.3f}")
        else:
            extra = " " + rec["error"][:160]
        print(f"[{rec['status']}] {arch} {shape} {mesh} ({time.time() - t0:.0f}s)"
              f"{extra}", flush=True)


if __name__ == "__main__":
    main()
