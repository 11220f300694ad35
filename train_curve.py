#!/usr/bin/env python3
"""Loss curve of examples/train_quickstart.py's recipe: the witness for
``chip_smoke.py`` phase 13's ``QUICKSTART_FALL`` gate.

The recipe is chip_smoke.py's ``QUICKSTART`` / ``QUICKSTART_RUN``
(llama-100m: d 512, 8 layers, 8 heads of 64, d_ff 2048, vocab 32,000; the
synthetic Markov stream at B=8, S=256; AdamW at lr 3e-3 with 20 warmup
steps over 300).  The example asserts last loss < first - 0.4.

    PYTHONPATH=src python train_curve.py --package both
    python3 train_curve.py --package port [--seed N] [--fault zero|neg]

``both`` (the CPU, ~10 s a step): the reference (``bundle.loss`` with
float32 activations and ``adamw_update``, jitted outside any mesh, as
tests/test_torch_training.py calls it) and the port (``make_train_step``
on the CPU) step for step from the same weights, the reference's
``init(PRNGKey(0))`` through ``params_from_jax``; prints both losses and
their gap.  The model is chaotic at init (a 1e-7 relative change of the
weights moves the step-0 loss by ~5e-4 at 8 layers), so the two curves
agree in their fall, not step by step.  ``port`` (the card): phase 13's
run, from the port's seeded init (``--seed``, 0 there); ``--fault``
corrupts what K1's backward kernel returns (``zero``: dq = dk = dv = 0;
``neg``: dq and dk negated), a faulted run for the gate to tell from a
sound one.

Prints the loss every 25 steps and, last, a JSON line with each curve's
first and last loss, first - last (the example's measure) and the mean of
the first 25 losses less the last 25's (the gate's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from chip_smoke import QUICKSTART, QUICKSTART_RUN, quickstart_bundle, train_run

R = QUICKSTART_RUN


def summary(losses: list) -> dict:
    return {"first": losses[0], "last": losses[-1],
            "drop": losses[0] - losses[-1],
            "fall": float(np.mean(losses[:25]) - np.mean(losses[-25:]))}


def both(steps: int) -> dict:
    """The reference and the port on the CPU, step for step, from the
    reference's init."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import get_bundle as jax_get_bundle
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticTokens as JaxSyntheticTokens
    from repro.models import transformer as jax_transformer
    from repro.models.api import bundle_for as jax_bundle_for
    from repro.training import AdamWConfig as JaxAdamWConfig
    from repro.training import adamw_init, adamw_update
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models.convert import params_from_jax
    from repro_torch.training import AdamWConfig, TrainStepConfig, make_train_step

    # the reference's loss embeds tokens in bf16: float32, like the port
    jax_transformer.embed_tokens = functools.partial(
        jax_transformer.embed_tokens, compute_dtype=jnp.float32)
    port = quickstart_bundle()
    ref = jax_bundle_for(QUICKSTART["name"], dataclasses.replace(
        jax_get_bundle("llama3-8b", reduced=True).cfg, **QUICKSTART))
    opt = dict(lr=R["lr"], warmup_steps=R["warmup"], total_steps=R["steps"])
    jopt = JaxAdamWConfig(**opt)
    jparams = ref.init(jax.random.PRNGKey(0), jnp.float32)
    jstate = adamw_init(jparams)
    step_fn, init_state = make_train_step(port, TrainStepConfig(
        opt=AdamWConfig(**opt)), "cpu")
    state = init_state(params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), port.cfg, device="cpu"))

    @jax.jit
    def jstep(params, st, batch):
        loss, grads = jax.value_and_grad(ref.loss)(params, batch)
        params, st, _ = adamw_update(jopt, params, grads, st)
        return params, st, loss

    data = dict(vocab=port.cfg.vocab, batch=R["batch"], seq_len=R["seq"])
    jdata, tdata = JaxSyntheticTokens(JaxDataConfig(**data)), \
        SyntheticTokens(DataConfig(**data))
    # the chaos at init: the reference's step-0 loss at its weights and at
    # its weights times 1 + 1e-7 N(0, 1)
    rng = np.random.default_rng(1)
    nudged = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a) * (
        1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32)), jparams)
    batch0 = jax.tree_util.tree_map(jnp.asarray, jdata.batch_at(0))
    l0, l1 = float(ref.loss(jparams, batch0)), float(ref.loss(nudged, batch0))
    print(f"reference step-0 loss {l0:.6f}, weights nudged by 1e-7 relative "
          f"{l1:.6f} (moved {abs(l1 - l0):.2e})", flush=True)
    del nudged
    curves = {"ref": [], "port": []}
    t0 = time.perf_counter()
    for i in range(steps):
        jparams, jstate, jloss = jstep(jparams, jstate, jax.tree_util.tree_map(
            jnp.asarray, jdata.batch_at(i)))
        state, m = step_fn(state, tdata.batch_at(i))
        curves["ref"].append(float(jloss))
        curves["port"].append(float(m["loss"]))
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d} loss ref {curves['ref'][-1]:.5f} port "
                  f"{curves['port'][-1]:.5f} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    gap = np.abs(np.subtract(curves["ref"], curves["port"]))
    return {"ref": summary(curves["ref"]), "port": summary(curves["port"]),
            "max_gap": float(gap.max()), "max_gap_step": int(gap.argmax()),
            "mean_gap": float(gap.mean())}


def port_card(steps: int, fault: str, seed: int) -> dict:
    """Phase 13's quickstart run on the card, K1's backward faulted or not."""
    import torch

    from repro_torch.kernels import flash_attention as k1

    if fault != "none":
        kernel = k1.flash_attention_bwd

        def faulted(*args, **kw):
            dq, dk, dv = kernel(*args, **kw)
            if fault == "zero":
                return dq * 0, dk * 0, dv * 0
            return -dq, -dk, dv

        faulted.launches = 0           # the kernel's wrapper counts on its name
        k1.flash_attention_bwd = faulted
    quick = quickstart_bundle()
    params = quick.init(torch.Generator(device="cuda").manual_seed(seed), "cuda",
                        torch.float32)
    _, losses, _, _, _ = train_run(
        quick, params, "cuda", steps=steps, batch=R["batch"], seq=R["seq"],
        lr=R["lr"], warmup=R["warmup"], total=R["steps"], compression=False)
    print("losses by 25: " + ", ".join(f"{x:.4f}" for x in losses[::25]))
    return {"fault": fault, "seed": seed, "port": summary(losses)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("both", "port"), required=True)
    ap.add_argument("--fault", choices=("none", "zero", "neg"), default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=R["steps"])
    args = ap.parse_args(argv)
    out = both(args.steps) if args.package == "both" else \
        port_card(args.steps, args.fault, args.seed)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
