"""Worker processes of the port's multi-process CPU tests (gloo).

Each worker joins a process group through a ``FileStore`` under the test's
``tmp_path`` (no TCP port: the suite runs in parallel workers), runs its
case and saves what it saw to ``<out>/rank<r>.pt``; the test process holds
the results against the reference and the one-process port.  The workers
import neither JAX nor the reference.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
from pathlib import Path

import torch
import torch.distributed as dist

WAIT_S = 240


def run(target, world: int, tmp: Path, *args) -> list[dict]:
    """``target(rank, world, tmp, *args)`` in ``world`` spawned processes;
    the ranks' saved results, in rank order."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(tmp), *args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WAIT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"workers failed: exit codes {[p.exitcode for p in procs]}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(target, rank, world, tmp, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(f"{tmp}/store", world))
    try:
        out = target(rank, world, Path(tmp), *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def f32_activations() -> None:
    """The port's activations in float32 (every family's ``embed_tokens``),
    as the tests' ``_f32_port`` fixture sets them."""
    from repro_torch.models import griffin, mamba2, transformer

    for mod in (transformer, mamba2, griffin):
        mod.embed_tokens = functools.partial(mod.embed_tokens,
                                             compute_dtype=torch.float32)


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #
def placements_case(rank, world, tmp, specs, shape, act_cases):
    """On a data 2 x model 2 mesh: each spec's block as ``distribute_tensor``
    places it, and ``constrain``'s redistribution of replicated
    activations."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import activation_mesh, constrain, placements
    from repro_torch.launch.mesh import make_small_mesh

    mesh = make_small_mesh(2, 2, device_type="cpu")
    x = torch.arange(int(torch.tensor(shape).prod()), dtype=torch.float32).reshape(shape)
    blocks = [distribute_tensor(x, mesh, placements(sp, mesh)).to_local()
              for sp in specs]
    acts = []
    with activation_mesh(mesh):
        for kind, a_shape in act_cases:
            h = distribute_tensor(torch.ones(a_shape), mesh,
                                  [Replicate(), Replicate()])
            out = constrain(h, kind)
            acts.append((tuple(out.placements), tuple(out.to_local().shape)))
    plain = torch.ones(4, 8, 6)
    with activation_mesh(mesh):
        same = constrain(plain, "hidden") is plain
    return {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
            "blocks": blocks, "acts": acts, "plain_unchanged": same}


def mesh_step_case(rank, world, tmp, cfg_kw, batches, serve):
    """The data-parallel train step on a data ``world`` x model 1 mesh, the
    serving functions on it, and a model axis of 2 refused."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models.api import ShapeSpec
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      make_serve_fns, make_train_step)

    f32_activations()
    bundle = get_bundle("llama3-8b", reduced=True)
    params = torch.load(tmp / "params.pt")
    mesh = make_small_mesh(world, 1, device_type="cpu")
    step_fn, init_state = make_train_step(bundle, TrainStepConfig(
        opt=AdamWConfig(**cfg_kw), grad_compression=True), "cpu", mesh=mesh)
    state = init_state(params=params)
    out = {"loss": [], "grad_norm": []}
    for batch in batches:
        state, m = step_fn(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"], out["residual"] = state["params"], state["residual"]

    serve_params = torch.load(tmp / "serve_params.pt")
    toks, cache, next_toks = serve["tokens"], serve["cache"], serve["next"]
    b, s = toks.shape
    fn, _ = make_serve_fns(bundle, mesh, ShapeSpec("p", s, b, "prefill"), "cpu")
    logits, pcache = fn(serve_params, {"tokens": toks})
    out["prefill"] = logits.full_tensor()
    out["prefill_cache"] = {k: v.full_tensor() for k, v in pcache["blocks"].items()}
    s_cache = cache["blocks"]["k"].shape[2]
    dfn, _ = make_serve_fns(bundle, mesh, ShapeSpec("d", s_cache, b, "decode"), "cpu")
    dec = []
    for i, tok in enumerate(next_toks):     # a global cache, then the DTensors
        dl, cache = dfn(serve_params, cache, tok, s + i)
        dec.append(dl.full_tensor())
    out["decode"] = dec
    out["decode_cache"] = {k: v.full_tensor() for k, v in cache["blocks"].items()}

    tp = make_small_mesh(1, 2, device_type="cpu")
    refused = []
    for make in (lambda: make_train_step(bundle, TrainStepConfig(), "cpu", mesh=tp),
                 lambda: make_serve_fns(bundle, tp, ShapeSpec("p", s, b, "prefill"),
                                        "cpu")):
        try:
            make()
            refused.append(False)
        except NotImplementedError:
            refused.append(True)
    out["tp_refused"] = refused
    return out
