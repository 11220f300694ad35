"""Serve a small model with batched requests (wave continuous batching):
the port's counterpart of examples/serve_batched.py.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_bundle
from repro_torch.device import resolve_device
from repro_torch.serving import Request, WaveBatcher


def main(device: str = "cuda", bundle=None, params=None, *, requests: int = 10,
         max_batch: int = 4, max_len: int = 96, new_tokens: int = 12) -> dict:
    """``requests`` prompts of 8-31 tokens (seed 0) through a
    :class:`WaveBatcher` on ``bundle`` and ``params`` (default: reduced
    llama3-8b from seed 0 on ``device``); returns the stats and requests."""
    dev = resolve_device(device)
    if bundle is None:
        bundle = get_bundle("llama3-8b", reduced=True)
    if params is None:
        params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                             torch.float32)

    batcher = WaveBatcher(bundle, params, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, bundle.cfg.vocab,
                                    rng.integers(8, 32), dtype=np.int32),
                max_new_tokens=new_tokens)
        for i in range(requests)
    ]
    for r in reqs:
        batcher.submit(r)
    stats = batcher.run()

    print(f"completed {stats.completed}/{len(reqs)} requests in {stats.waves} waves")
    print(f"prefill tokens {stats.prefill_tokens}, decode steps {stats.decode_steps}")
    print(f"mean slot occupancy {np.mean(stats.slot_occupancy):.2f}")
    for r in reqs[:3]:
        print(f"req {r.rid}: {len(r.output)} tokens -> {r.output[:8]}...")
    if not all(r.done and len(r.output) > 0 for r in reqs):
        raise AssertionError("a request did not complete")
    print("OK")
    return {"stats": stats, "requests": reqs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
