"""Training driver: train steps + checkpoint/restart + straggler watch.

Runs real training of the reduced model (``--reduced`` is always on, as in
the reference) of any family: the forward and backward kernels of K1 in
every attention layer, K4 in every Mamba-2 block and K5 in every recurrent
layer, K2a/K2b on every gradient with ``--grad-compression``.
``--mesh-data`` x ``--mesh-model`` above 1 trains on that mesh, one process
a device under ``torchrun`` (``launch/mesh.py``'s process group; gloo with
``--device cpu``): data-parallel, and tensor-parallel on a "model" axis
above 1 (the dense GQA transformers), the state stored FSDP × TP.
Fault drill: ``--kill-at-step N`` exits with code 42 after step N;
re-launching with the same ``--ckpt-dir`` resumes from the latest checkpoint
and the data pipeline reproduces the exact batch stream (deterministic
seek).  Checkpoints hold the whole state (rank 0 writes), so another mesh
shape, or the reference, restores them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir <dir>
  (``--arch mamba2-1.3b`` or ``--arch recurrentgemma-9b`` trains the SSM or
  the hybrid family)
  (``--device cpu`` runs on the CPU; the default is cuda)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --mesh-model 2 --steps 20 --batch 4 --seq 64
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

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

    dev = resolve_device(args.device)
    mesh, rank = None, 0
    n = args.mesh_data * args.mesh_model
    if n > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_small_mesh

        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) < n:
            ap.error(f"--mesh-data {args.mesh_data} x --mesh-model "
                     f"{args.mesh_model} trains in {n} processes, one a device "
                     "(torchrun --nproc-per-node ...)")
        if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_small_mesh(args.mesh_data, args.mesh_model,
                               device_type=dev.type)
        rank = dist.get_rank()
    bundle = get_bundle(args.arch, reduced=args.reduced)
    cfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        grad_compression=args.grad_compression,
    )
    step_fn, init_state = make_train_step(bundle, cfg, dev, mesh=mesh)
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
            if rank == 0:
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
        if step % args.log_every == 0 and rank == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if ckpt is not None:
            ckpt.maybe_save(step + 1, state)
        if args.kill_at_step is not None and step + 1 == args.kill_at_step:
            if rank == 0:
                print(f"[fault-injection] dying at step {step + 1}", flush=True)
            sys.exit(42)
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "losses": losses}


if __name__ == "__main__":
    out = main()
    if "RANK" not in os.environ or os.environ["RANK"] == "0":
        print(out)
