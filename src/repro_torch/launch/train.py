"""Training driver: train steps + checkpoint/restart + straggler watch.

Runs real training of the reduced model (``--reduced`` is always on, as in
the reference) of any family on one device: the forward and backward
kernels of K1 in every attention layer, K4 in every Mamba-2 block and K5
in every recurrent layer, K2a/K2b on every gradient with
``--grad-compression``.
Fault drill: ``--kill-at-step N`` exits with code 42 after step N;
re-launching with the same ``--ckpt-dir`` resumes from the latest checkpoint
and the data pipeline reproduces the exact batch stream (deterministic
seek).  This entry point trains on one device, so ``--mesh-data`` and
``--mesh-model`` take 1 only (the data-parallel step is
``make_train_step(..., mesh=...)``, which the train-quickstart example runs
under ``torchrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir <dir>
  (``--arch mamba2-1.3b`` or ``--arch recurrentgemma-9b`` trains the SSM or
  the hybrid family)
  (``--device cpu`` runs on the CPU; the default is cuda)
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_bundle
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.distributed import StragglerDetector
from repro_torch.training import AdamWConfig, TrainStepConfig, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at-step", type=int, default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.mesh_data, args.mesh_model) != (1, 1):
        ap.error("launch.train trains on one device: --mesh-data and "
                 "--mesh-model take 1 (repro_torch.examples.train_quickstart "
                 "runs the data-parallel step under torchrun)")

    dev = resolve_device(args.device)
    bundle = get_bundle(args.arch, reduced=args.reduced)
    cfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        grad_compression=args.grad_compression,
    )
    step_fn, init_state = make_train_step(bundle, cfg, dev)
    data = SyntheticTokens(
        DataConfig(vocab=bundle.cfg.vocab, batch=args.batch, seq_len=args.seq))

    state = init_state(0)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir, args.ckpt_every) if args.ckpt_dir \
        else None
    if ckpt is not None:
        resumed, at = ckpt.resume(state)
        if resumed is not None:
            state = resumed
            start_step = at
            print(f"[resume] from step {at}", flush=True)
    data.seek(start_step)

    detector = StragglerDetector()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, next(data))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        detector.observe(0, dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if ckpt is not None:
            ckpt.maybe_save(step + 1, state)
        if args.kill_at_step is not None and step + 1 == args.kill_at_step:
            print(f"[fault-injection] dying at step {step + 1}", flush=True)
            sys.exit(42)
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses)}


if __name__ == "__main__":
    out = main()
    print(out)
