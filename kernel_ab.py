#!/usr/bin/env python3
"""K1, K1's backward, K2, K3, K4 and K4's backward of two checkouts, timed on one card in turns.

Run from the root of a checkout, on a machine with one NVIDIA H100, with a
second checkout (for example the parent commit, unpacked by ``git archive``
into a directory that ``.gitignore`` lists):

    python3 kernel_ab.py --other build/parent [--sweep]

Each checkout is measured in its own process (each imports its own
``repro_torch`` and builds its own kernels), in the order other, this, this,
other, so a drift of the card over the run shows as a gap between the two
readings of one checkout.  Every measurement prints the device time per call
of K1 (flash prefill attention) at Llama-3-8B's prefill shape and at
Griffin's hd 256 shape, of K3 (decode attention) at the generation path's
decode shape, and of K4 (the SSD chunk scan, bf16, final state returned) at
Mamba-2's prefill shape, of K1's float32 forward with lse (as training
calls it) at Llama-3-8B's and the quickstart's training shapes, of K1's
backward (float32, and bf16 where the checkout builds it) at Llama-3-8B's
training shape, the quickstart's (hd 64), at hd 8 with G=7 and at
gemma2-9b's, recurrentgemma-9b's (hd 256) and deepseek-v2-lite's (MLA)
(``chip_smoke.TRAIN_BWD``; where a checkout builds the instance), of K4's
float32 forward and K4's backward at each shape of ``chip_smoke.SSD_BWD``
(Mamba-2's training shape first), from a CUDA-graph replay
(``chip_smoke.graph_ms``),
beside the device time of each kernel the call launches, by name
(``chip_smoke.kernel_split``: a two-kernel K3 shows its split and its
combine; K4 its kernels), and K3 again at fewer valid cache entries (time
against ``cur_len`` separates its fixed cost from its per-key cost).  K2a
(int8 quantize, bf16) is timed at both boundary widths, [512, 4096] and
[512, 2048], with its input in L2 and, at [512, 4096], over a ring of
inputs larger than the L2; K2b (dequantize) at [512, 4096].  ``--sweep``
also times this checkout's K3 over other values of
``BLOCKS_PER_SM``, the split plan's one knob, and its bf16 K1 backward
over the values of ``BWD_MIN_ITEMS`` that change its plan (the query heads
a dK/dV work item walks, ``bwd_heads_per_item``).  Prints one JSON line per
measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

# (label, b, s, h, kv, hd, window): K1 at the two model paths' prefill shapes
K1_SHAPES = [("llama", 1, 512, 32, 8, 128, 0),
             ("griffin", 1, 512, 16, 1, 256, 2048)]
# K1's backward at these rows of chip_smoke.TRAIN_BWD (each where the
# measured checkout builds its instance)
K1_BWD_SHAPES = ("llama3-8b", "quickstart", "hd 8, G=7", "gemma2-9b local",
                 "recurrentgemma-9b", "deepseek-v2-lite")


def measure_k2(cs, k2) -> list[dict]:
    """K2a at both boundary widths (L2-warm; L2-cold at the first), K2b."""
    import torch

    rows = []
    for shape in (cs.ROWS, cs.MAMBA_ROWS):
        x = cs.normal(shape, torch.bfloat16, 4) * 3

        def quant(x=x):
            return k2.quantize_int8(x)

        quant()
        torch.cuda.synchronize()
        rows.append(dict(kernel="K2a", shape=f"{shape[0]}x{shape[1]}",
                         us=1e3 * cs.graph_ms(quant, 200),
                         by_name=cs.kernel_split(quant, 50)))
    x = cs.normal(cs.ROWS, torch.bfloat16, 4) * 3
    copies = [x] + [x.clone() for _ in range(int(cs.L2_COLD_BYTES // (2 * x.numel())))]
    ring = itertools.cycle(copies)
    rows.append(dict(kernel="K2a", shape=f"{cs.ROWS[0]}x{cs.ROWS[1]} L2-cold",
                     us=1e3 * cs.graph_ms(lambda: k2.quantize_int8(next(ring)),
                                          8 * len(copies))))
    q, s = k2.quantize_int8(x)

    def dequant():
        return k2.dequantize_int8(q, s, torch.bfloat16)

    rows.append(dict(kernel="K2b", shape=f"{cs.ROWS[0]}x{cs.ROWS[1]}",
                     us=1e3 * cs.graph_ms(dequant, 200),
                     by_name=cs.kernel_split(dequant, 50)))
    return rows


def measure_k4_f32(cs, k4) -> list[dict]:
    """K4's float32 forward (as training calls it: the final state only
    with a state_in) and K4's backward at each shape of ``cs.SSD_BWD``."""
    import torch

    rows, seen = [], set()
    for label, b, s, h, g, n, p, chunk, with_state, _ in cs.SSD_BWD:
        if (b, s, h, g, n, p, chunk, with_state) in seen:
            continue                    # the work does not depend on dt's values
        seen.add((b, s, h, g, n, p, chunk, with_state))
        x, dt, a, bm, cm, st = cs.ssd_inputs(b, s, h, g, n, p, torch.float32, 41)
        st = st if with_state else None
        dy = cs.normal((b, s, h, p), torch.float32, 46)
        ds = cs.normal((b, h, n, p), torch.float32, 47) if with_state else None

        def fwd(x=x, dt=dt, a=a, bm=bm, cm=cm, st=st, chunk=chunk, ret=with_state):
            return k4.ssd(x, dt, a, bm, cm, chunk=chunk, state_in=st, return_state=ret)

        def bwd(x=x, dt=dt, a=a, bm=bm, cm=cm, dy=dy, st=st, ds=ds, chunk=chunk):
            return k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st, dstate=ds)

        for kernel, fn, iters in (("K4 f32", fwd, 20), ("K4 bwd", bwd, 10)):
            fn()
            torch.cuda.synchronize()
            rows.append(dict(kernel=kernel, shape=label, us=1e3 * cs.graph_ms(fn, iters),
                             by_name=cs.kernel_split(fn, iters)))
    return rows


def measure(root: pathlib.Path, sweep: bool) -> list[dict]:
    import chip_smoke as cs  # this checkout's timing helpers
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import int8_transfer as k2
    from repro_torch.kernels import ssd_chunk as k4

    rows = measure_k2(cs, k2)
    b, s, h, g, n, p, chunk = cs.SSD_PATH.values()
    x, dt, a, bm, cm, _ = cs.ssd_inputs(b, s, h, g, n, p, torch.bfloat16, 21)

    def ssd():
        return k4.ssd(x, dt, a, bm, cm, chunk=chunk, return_state=True)

    ssd()
    torch.cuda.synchronize()
    rows.append(dict(kernel="K4", shape="mamba2", us=1e3 * cs.graph_ms(ssd, 50),
                     by_name=cs.kernel_split(ssd, 20)))
    for label, b, s, h, kv, hd, window in K1_SHAPES:
        q = cs.normal((b, s, h, hd), torch.bfloat16, 1)
        k = cs.normal((b, s, kv, hd), torch.bfloat16, 2)
        v = cs.normal((b, s, kv, hd), torch.bfloat16, 3)

        def call():
            return k1.flash_attention(q, k, v, window=window)

        call()
        torch.cuda.synchronize()
        rows.append(dict(kernel="K1", shape=label, us=1e3 * cs.graph_ms(call, 50),
                         by_name=cs.kernel_split(call, 20)))

    for label, b, s, h, kv, hd, _, _, _, _ in cs.TRAIN_BWD[:2]:
        q, k, v = (cs.normal(shape, torch.float32, seed) for shape, seed in (
            ((b, s, h, hd), 21), ((b, s, kv, hd), 22), ((b, s, kv, hd), 23)))

        def fwd(q=q, k=k, v=v):
            return k1.flash_attention_lse(q, k, v)

        fwd()
        torch.cuda.synchronize()
        rows.append(dict(kernel="K1 f32", shape=label, us=1e3 * cs.graph_ms(fwd, 20),
                         by_name=cs.kernel_split(fwd, 20)))

    for label, b, s, h, kv, hd, hd_v, window, cap, scale in cs.TRAIN_BWD:
        for dt, name in ((torch.float32, "K1 bwd"), (torch.bfloat16, "K1 bwd bf16")):
            if label not in K1_BWD_SHAPES or not k1.supported_bwd(hd, hd_v, dt):
                continue                # a checkout without this instance
            q, k, v, do = (cs.normal(shape, dt, seed) for shape, seed in (
                ((b, s, h, hd), 21), ((b, s, kv, hd), 22), ((b, s, kv, hd_v), 23),
                ((b, s, h, hd_v), 24)))
            kw = dict(causal=True, window=window, logit_cap=cap, scale=scale)
            o, lse = k1.flash_attention_lse(q, k, v, **kw)

            def bwd(q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw):
                return k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)

            bwd()
            torch.cuda.synchronize()
            rows.append(dict(kernel=name, shape=label, us=1e3 * cs.graph_ms(bwd, 20),
                             by_name=cs.kernel_split(bwd, 20)))
            if sweep and dt == torch.bfloat16 and hasattr(k1, "BWD_MIN_ITEMS"):
                default, plans = k1.BWD_MIN_ITEMS, {}
                for m in (1, 132, 264, 10 ** 9):   # whole groups .. one head an item
                    k1.BWD_MIN_ITEMS = m
                    plans.setdefault(k1.bwd_heads_per_item(b, s, h, kv), m)
                for heads, m in sorted(plans.items()):
                    k1.BWD_MIN_ITEMS = m
                    bwd()
                    torch.cuda.synchronize()
                    rows.append(dict(kernel=name, shape=f"{label} heads={heads}",
                                     min_items=m, us=1e3 * cs.graph_ms(bwd, 20),
                                     by_name=cs.kernel_split(bwd, 20)))
                k1.BWD_MIN_ITEMS = default

    rows += measure_k4_f32(cs, k4)

    b, s, h, kv, hd = cs.DECODE.values()
    q = cs.normal((b, h, hd), torch.bfloat16, 5)
    caches = [(cs.normal((b, s, kv, hd), torch.bfloat16, 6 + 2 * i),
               cs.normal((b, s, kv, hd), torch.bfloat16, 7 + 2 * i))
              for i in range(3)]          # 63 MB: each call finds its cache cold
    cur = torch.tensor(cs.DECODE_CUR, dtype=torch.int32, device="cuda")
    ring = itertools.cycle(caches)

    def dec():
        return k3.decode_attention(q, *next(ring), cur)

    plans = [k3.BLOCKS_PER_SM] + ([x for x in (1, 3, 4, 6) if x != k3.BLOCKS_PER_SM]
                                  if sweep else [])
    default = k3.BLOCKS_PER_SM
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for bps in plans:
        k3.BLOCKS_PER_SM = bps
        dec()
        torch.cuda.synchronize()
        rows.append(dict(kernel="K3", shape="decode", blocks_per_sm=bps,
                         split=list(k3.split_plan(b, h, kv, s, n_sm)),
                         us=1e3 * cs.graph_ms(dec, 192),
                         by_name=cs.kernel_split(dec, 48)))
    k3.BLOCKS_PER_SM = default
    # the same call at fewer valid keys: time against cur_len separates the
    # per-call fixed cost (launch, cur_len, fold, combine) from the per-key one
    for valid in (1, 64, 128, 256, 384):
        cur_v = torch.tensor(valid, dtype=torch.int32, device="cuda")
        rows.append(dict(kernel="K3", shape=f"decode cur_len={valid}",
                         us=1e3 * cs.graph_ms(
                             lambda c=cur_v: k3.decode_attention(q, *next(ring), c),
                             192)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--measure", type=pathlib.Path,
                    help="(internal) measure the checkout at this root")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this checkout's K3 over BLOCKS_PER_SM and its "
                         "bf16 K1 backward over BWD_MIN_ITEMS")
    args = ap.parse_args()
    if args.measure is not None:
        for row in measure(args.measure.resolve(), args.sweep):
            print("AB " + json.dumps(row))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        print("kernel_ab: --other must name another checkout's root", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    order = [("other", args.other), ("this", ROOT), ("this", ROOT),
             ("other", args.other)]
    for turn, (who, root) in enumerate(order):
        cmd = [sys.executable, str(ROOT / "kernel_ab.py"), "--measure", str(root)]
        if args.sweep and who == "this" and turn == 1:
            cmd.append("--sweep")
        run = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            if line.startswith("AB "):
                row = json.loads(line[3:])
                by_name = {k: round(v, 3)
                           for k, v in row.pop("by_name", {}).items()}
                print(json.dumps({"turn": turn, "checkout": who, **row,
                                  "us": round(row["us"], 3),
                                  "profiler_us_by_kernel": by_name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
