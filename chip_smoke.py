#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. print the card's name and power limit, build the Hopper kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   serving shapes (K1 flash prefill attention: bf16 2e-2 / fp32 2e-5, the
   tolerances of tests/test_kernels.py; K2 int8 quantize/dequantize: bit for
   bit) and time kernel, plain version and, for K1, PyTorch's
   ``scaled_dot_product_attention`` as a yardstick (the port never calls it);
3. serve 8 requests of 512 tokens through full-width, full-depth bf16
   Llama-3-8B (random weights from a seed) with int8 boundaries, through
   ``repro_torch.launch.serve``;
4. follow examples/quickstart.py steps 3-5 at full width: deploy the even
   3-way split, congest, re-split, and check split == monolith (1e-3);
5. hold the reduced model on the card against the same model on the CPU
   (the plain versions) on a small input;
6. check the launch counts of phases 3 and 4, print the ``kernels`` line
   and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM datasheet peaks: HBM bytes/s, dense
# bf16 tensor FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

PATH = dict(b=1, s=512, h=32, kv=8, hd=128)      # llama3-8b prefill, 512 tokens
ROWS = (512, 4096)                                # one boundary at that shape
SERVE_ARGV = ["--full", "--param-dtype", "bfloat16", "--compress",
              "--requests", "8", "--prompt-len", "512", "--device", "cuda"]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str | None = None) -> float | None:
    """Device time per call of ``fn``: the kernels it launches, summed from a
    ``torch.profiler`` trace of ``iters`` warm calls (host enqueue time is
    left out).  With ``kernel``, only kernels whose name holds it count.
    None when the trace holds no such device events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in device_events(prof)
          if kernel is None or kernel_matches(e.name, kernel)]
    return sum(us) / iters / 1e3 if us else None


def device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_matches(name: str, kernel: str) -> bool:
    # "quantize_rows" is also a substring of "dequantize_rows"
    return kernel in name and not (kernel == "quantize_rows"
                                   and "dequantize_rows" in name)


def timed(label: str, fn, iters: int, kernel: str | None = None) -> float:
    """Device ms per call (profiler), beside the launch-to-launch time that
    CUDA events measure over back-to-back calls (host overhead included)."""
    ev = cuda_ms(fn, iters)
    dev = device_ms(fn, iters, kernel)
    print(f"  {label}: device {dev if dev is None else round(dev, 5)} ms/call; "
          f"events {ev:.5f} ms/call")
    if dev is None:
        print(f"  {label}: the profiler saw no device events; reporting the "
              f"CUDA-event time")
        return ev
    return dev


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the products this input needs."""
    qp = np.arange(s)[:, None]
    kp = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    return int(keep.sum())


def normal(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def phase_kernels(k1, k2) -> list[dict]:
    """Phase 2: every kernel against its plain version; times and bounds."""
    import torch.nn.functional as F

    rows = []
    # ---- K1 at the path shape and the edge cases ----
    cases = [  # (label, dtype, tol, b, s, h, kv, hd, window, cap)
        ("path", torch.bfloat16, 2e-2, *PATH.values(), 0, 0.0),
        ("ragged", torch.bfloat16, 2e-2, 2, 77, 32, 8, 128, 0, 0.0),
        ("window", torch.bfloat16, 2e-2, 1, 512, 32, 8, 128, 128, 0.0),
        ("softcap", torch.bfloat16, 2e-2, 1, 512, 32, 8, 128, 0, 50.0),
        ("fp32", torch.float32, 2e-5, *PATH.values(), 0, 0.0),
    ]
    k1_err = None
    for label, dt, tol, b, s, h, kv, hd, window, cap in cases:
        q = normal((b, s, h, hd), dt, 1)
        k = normal((b, s, kv, hd), dt, 2)
        v = normal((b, s, kv, hd), dt, 3)
        got = k1.flash_attention(q, k, v, window=window, logit_cap=cap)
        torch.cuda.synchronize()
        want = k1.flash_attention_plain(q, k, v, window=window, logit_cap=cap)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        err = float((got.float() - want.float()).abs().max())
        print(f"K1 {label}: {tuple(q.shape)} {dt} window={window} cap={cap} "
              f"max_abs_err={err:.3e} (tol {tol})")
        if label == "path":
            k1_err = err
            ms = timed("K1 kernel", lambda: k1.flash_attention(q, k, v), 50,
                       "flash_fwd_kernel")
            plain_ms = timed("K1 plain", lambda: k1.flash_attention_plain(q, k, v), 10)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = timed("K1 sdpa", lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 50)
            n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
            n_flops = 4.0 * hd * b * h * attention_pairs(s, True, 0)
            b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
            k1_row = dict(name="flash_attention", route="cuda",
                          source="src/repro_torch/kernels/csrc/flash_attention.cu",
                          replaces="src/repro/kernels/flash_attention.py:88",
                          max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            print(f"K1 time {ms:.4f} ms; plain {plain_ms:.4f} ms; "
                  f"sdpa {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}: "
                  f"{n_bytes / 1e6:.2f} MB, {n_flops / 1e9:.3f} GFLOP)")
    rows.append(k1_row)

    # ---- K2 on one boundary's rows, bf16 (the path) and fp32 ----
    for dt in (torch.bfloat16, torch.float32):
        x = normal(ROWS, dt, 4) * 3
        q, s = k2.quantize_int8(x)
        torch.cuda.synchronize()
        pq, ps = k2.quantize_int8_plain(x)
        if not (torch.equal(q, pq) and torch.equal(s, ps)):
            raise AssertionError(f"K2a {dt}: q/scales differ from the plain version")
        y = k2.dequantize_int8(q, s, dt)
        py = k2.dequantize_int8_plain(q, s, dt)
        if not torch.equal(y, py):
            raise AssertionError(f"K2b {dt}: output differs from the plain version")
        print(f"K2 {ROWS} {dt}: q, scales and dequantized rows bit-identical")
        if dt != torch.bfloat16:
            continue
        n, d = ROWS
        qa_ms = timed("K2a kernel", lambda: k2.quantize_int8(x), 200,
                      "quantize_rows")
        qa_plain = timed("K2a plain", lambda: k2.quantize_int8_plain(x), 50)
        qa_bytes = x.numel() * 2 + q.numel() + s.numel() * 4
        qa_b, qa_by = bound(qa_bytes, 6.0 * n * d, FP32_FLOPS)   # abs,max,div,rint,clip x2
        dq_ms = timed("K2b kernel", lambda: k2.dequantize_int8(q, s, dt), 200,
                      "dequantize_rows")
        dq_plain = timed("K2b plain", lambda: k2.dequantize_int8_plain(q, s, dt), 50)
        dq_bytes = q.numel() + s.numel() * 4 + y.numel() * 2
        dq_b, dq_by = bound(dq_bytes, 2.0 * n * d, FP32_FLOPS)   # convert, multiply
        rows.append(dict(name="quantize_int8", route="cuda",
                         source="src/repro_torch/kernels/csrc/int8_transfer.cu",
                         replaces="src/repro/kernels/int8_transfer.py:32",
                         max_abs_err=0.0, ms=qa_ms, plain_ms=qa_plain,
                         bound_ms=qa_b, bound_by=qa_by, library_ms=None))
        rows.append(dict(name="dequantize_int8", route="cuda",
                         source="src/repro_torch/kernels/csrc/int8_transfer.cu",
                         replaces="src/repro/kernels/int8_transfer.py:54",
                         max_abs_err=0.0, ms=dq_ms, plain_ms=dq_plain,
                         bound_ms=dq_b, bound_by=dq_by, library_ms=None))
        print(f"K2a time {qa_ms:.4f} ms; plain {qa_plain:.4f} ms; bound "
              f"{qa_b:.5f} ms ({qa_by}); K2b time {dq_ms:.4f} ms; plain "
              f"{dq_plain:.4f} ms; bound {dq_b:.5f} ms ({dq_by})")
    return rows


def request_breakdown(engine, toks) -> None:
    """One traced request: device time by kernel family and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer_logits(toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"flash_fwd_kernel": "K1", "quantize_rows": "K2",
                "gemm": "matmul", "nvjet": "matmul", "xmma": "matmul",
                "cutlass": "matmul"}
    split: dict[str, float] = {}
    for e in device_events(prof):
        fam = next((f for key, f in families.items() if key in e.name.lower()),
                   "other")
        split[fam] = split.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(split.values())
    print(f"request trace: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms, idle share {1.0 - busy / wall_ms:.3f}; by family (ms): "
          + json.dumps({k: round(v, 4) for k, v in sorted(split.items())}))


def reset(counters) -> None:
    for fn in counters:
        fn.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke test runs only on one",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_bundle
    from repro_torch.core import (AdaptiveOrchestrator, CapacityProfiler,
                                  InProcessAgent, ReconfigurationBroadcast,
                                  SplitRevision, Thresholds, Workload)
    from repro_torch.edgesim import MECScenarioParams, base_system_state
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import int8_transfer as k2
    from repro_torch.launch import serve
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving import (ActivationTransport, SegmentChain,
                                     SplitInferenceEngine)

    counters = (k1.flash_attention, k2.quantize_int8, k2.dequantize_int8)
    t_start = time.perf_counter()
    # the float32 plain versions are references: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card, build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} capability "
          f"{torch.cuda.get_device_capability(0)}")
    res = build.build()
    print(f"kernel build: {res.seconds:.1f} s -> {res.path.relative_to(ROOT)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    # ---- phase 2: kernels against their plain versions ----
    rows = phase_kernels(k1, k2)

    # ---- phase 3: serve (the main path) ----
    reset(counters)
    t0 = time.perf_counter()
    out, engine = serve.run(serve.parse_args(SERVE_ARGV))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = {fn.__name__: fn.launches for fn in counters}
    print(f"serve {SERVE_ARGV}: {out} in {serve_s:.1f} s (init included)")
    print(f"serve launches: {serve_counts}")
    n_layers = engine.bundle.cfg.n_layers
    transfers = engine.transfer_stats().transfers
    if serve_counts["flash_attention"] != n_layers * 8:
        raise AssertionError(f"flash launches {serve_counts} != {n_layers} x 8")
    if not (serve_counts["quantize_int8"] == serve_counts["dequantize_int8"]
            == transfers > 0):
        raise AssertionError(f"int8 launches {serve_counts} != {transfers} transfers")
    # request latency at the served shape, after the counted run
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, engine.bundle.cfg.vocab, (1, 512), dtype=np.int32), device="cuda")
    req = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.infer_logits(toks)
        torch.cuda.synchronize()
        req.append((time.perf_counter() - t0) * 1e3)
    print(f"request prefill (512 tokens, split {engine.config.boundaries}): "
          f"{[round(r, 3) for r in req]} ms; median {float(np.median(req)):.3f} ms")
    request_breakdown(engine, toks)
    del engine
    torch.cuda.empty_cache()

    # ---- phase 4: quickstart at full width ----
    bundle = get_bundle("llama3-8b", reduced=False)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0), "cuda",
                         torch.bfloat16)
    graph = bundle.model_graph()
    state = base_system_state(MECScenarioParams(backhaul_mbps=20.0))
    profiler = CapacityProfiler(base_state=state)
    orch = AdaptiveOrchestrator(
        graph=graph, profiler=profiler,
        broadcast=ReconfigurationBroadcast(
            [InProcessAgent(i) for i in range(state.num_nodes)]),
        workload=Workload(tokens_in=56, tokens_out=8, arrival_rate=4.0),
        thresholds=Thresholds(), splitter=SplitRevision(device="cuda"))
    cfg = orch.deploy_initial(graph.even_split(3).boundaries, (0, 3, 0))
    print(f"quickstart: initial split {cfg.boundaries} on {cfg.assignment}")
    profiler.observe_latency(0.450)
    profiler.observe_links(state.link_bw)
    decision = orch.step(now=100.0)
    print(f"quickstart: {decision.kind.value} {list(decision.reasons)} -> "
          f"{orch.current.boundaries} on {orch.current.assignment}")
    qs_engine = SplitInferenceEngine(bundle, params)
    qs_engine.apply_config(orch.current)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, bundle.cfg.vocab, (2, 16), dtype=np.int32), device="cuda")
    reset(counters)
    split_logits = qs_engine.infer_logits(toks)
    mono_logits = qs_engine.infer_monolithic(toks)
    torch.cuda.synchronize()
    qs_counts = {fn.__name__: fn.launches for fn in counters}
    if tuple(split_logits.shape) != (2, 16, bundle.cfg.vocab) or \
            not bool(torch.isfinite(split_logits).all()):
        raise AssertionError(f"split logits {tuple(split_logits.shape)} not finite")
    err = float((split_logits - mono_logits).abs().max())
    print(f"quickstart: split vs monolithic max |dlogit| = {err:.2e}; "
          f"launches {qs_counts}")
    if not err < 1e-3:
        raise AssertionError(f"split != monolith: {err}")
    if qs_counts != {"flash_attention": 2 * bundle.cfg.n_layers,
                     "quantize_int8": 0, "dequantize_int8": 0}:
        raise AssertionError(f"quickstart launches {qs_counts}")
    del qs_engine, params, split_logits, mono_logits
    torch.cuda.empty_cache()

    # ---- phase 5: card vs CPU on the reduced model (small input) ----
    small = get_bundle("llama3-8b", reduced=True)
    cpu_params = small.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    gpu_params = tree_map(lambda a: a.to("cuda"), cpu_params)
    toks = np.random.default_rng(2).integers(0, small.cfg.vocab, (2, 24),
                                             dtype=np.int32)
    bounds = (0, 2, 3, len(small.model_graph()))
    ref = SegmentChain(small, cpu_params, bounds,
                       ActivationTransport(compress=True))(torch.as_tensor(toks))
    reset(counters)
    got = SegmentChain(small, gpu_params, bounds, ActivationTransport(
        compress=True))(torch.as_tensor(toks, device="cuda")).cpu()
    small_counts = {fn.__name__: fn.launches for fn in counters}
    if small_counts != {"flash_attention": small.cfg.n_layers,
                        "quantize_int8": 2, "dequantize_int8": 2}:
        raise AssertionError(f"reduced model on the card: launches {small_counts}")
    scale = float(ref.abs().max())
    d = (got - ref).abs()
    print(f"reduced model, card vs CPU: max |d| {float(d.max()):.4f}, mean "
          f"{float(d.mean()):.5f}, logit scale {scale:.3f}")
    if not (float(d.max()) <= 0.10 * scale and float(d.mean()) <= 0.005 * scale):
        raise AssertionError("card and CPU disagree on the reduced model")

    # ---- phase 6: result ----
    for row in rows:
        row["launches"] = serve_counts[row["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
