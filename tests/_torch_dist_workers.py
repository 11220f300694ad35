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
    return finish(start(target, world, tmp, *args), tmp)


def start(target, world: int, tmp: Path, *args) -> list:
    """:func:`run`'s processes, started; :func:`finish` waits for them (the
    caller works in between)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(tmp), *args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish(procs: list, tmp: Path) -> list[dict]:
    """The results of :func:`start`'s processes, in rank order."""
    world = len(procs)
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


def f32_serving(serve, embed_fn, dtype) -> None:
    """A package's transformer serving in float32: its ``transformer_serve``
    module's ``embed_tokens`` (``embed_fn``, the transformer module's) and
    the cache ``prefill`` makes (the bundles call both through the module),
    as ``tests/test_torch_tp_serve.py`` sets them in both packages."""
    serve.embed_tokens = functools.partial(embed_fn, compute_dtype=dtype)
    serve.prefill = functools.partial(serve.prefill, cache_dtype=dtype)


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


def _state_out(state) -> dict:
    """A mesh train step's state tensors (params, AdamW's moments, the
    residual), gathered whole and as this rank's blocks."""
    from repro_torch.distributed.fsdp import full_tensor
    from repro_torch.models.common import tree_map

    tensors = {"params": state["params"], "mu": state["opt"]["mu"],
               "nu": state["opt"]["nu"], "residual": state["residual"]}
    return {"whole": tree_map(full_tensor, tensors),
            "local": tree_map(lambda t: t.to_local().clone(), tensors)}


def whole_grads(step_fn, state, batch, mesh):
    """(loss, the gradient leaves gathered whole) of a mesh train step's
    ``loss_and_grads``: the step's gradients before compression."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.fsdp import full_tensor, spec_leaves
    from repro_torch.distributed.sharding import placements

    loss, flat = step_fn.loss_and_grads(state, batch)
    return loss, [full_tensor(DTensor.from_local(g, mesh, placements(sp, mesh),
                                                 run_check=False))
                  for g, sp in zip(flat, spec_leaves(step_fn.param_specs))]


def mesh_step_case(rank, world, tmp, cfg_kw, batches, serve):
    """The data-parallel train step on a data ``world`` x model 1 mesh (its
    state gathered whole and as this rank's blocks), the serving functions
    on it; on a model axis of ``world`` the train steps and the serving
    functions of the MoE, MLA, Mamba-2 and Griffin families refused, and
    the dense serving functions run (in float32 serving, beside the
    one-process calls made here)."""
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
    out.update(_state_out(state))
    out["coord"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

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

    tp = make_small_mesh(1, world, device_type="cpu")
    refused = []
    others = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "mamba2-1.3b",
              "recurrentgemma-9b")
    makers = [lambda a=a: make_train_step(get_bundle(a, reduced=True),
                                          TrainStepConfig(), "cpu", mesh=tp)
              for a in others]
    makers += [lambda a=a: make_serve_fns(get_bundle(a, reduced=True), tp,
                                          ShapeSpec("p", s, b, "prefill"), "cpu")
               for a in others]
    for make in makers:
        try:
            make()
            refused.append(False)
        except NotImplementedError:
            refused.append(True)
    out["tp_refused"] = refused

    from repro_torch.models import transformer, transformer_serve

    f32_serving(transformer_serve, transformer.embed_tokens, torch.float32)
    fn, _ = make_serve_fns(bundle, tp, ShapeSpec("p", s, b, "prefill"), "cpu")
    logits, tcache = fn(serve_params, {"tokens": toks}, max_len=s_cache)
    dfn, _ = make_serve_fns(bundle, tp, ShapeSpec("d", s_cache, b, "decode"), "cpu")
    dl, tcache = dfn(serve_params, tcache, next_toks[0], s)
    want, wcache = bundle.prefill(serve_params, {"tokens": toks}, s_cache)
    want_d, wcache = bundle.decode(serve_params, wcache, next_toks[0], s)
    out["tp_serve"] = [(logits.full_tensor(), want), (dl.full_tensor(), want_d),
                       (tcache["blocks"]["k"].full_tensor(), wcache["blocks"]["k"])]
    return out


def dp_family_case(rank, world, tmp, cfg_kw, cases, serve):
    """Per (arch, batches) of ``cases``: the data-parallel train step on a
    data ``world`` x model 1 mesh with int8 gradients from the params saved
    as ``<arch>.pt`` (float32 activations): its losses, grad norms and
    state (:func:`_state_out`); the params ``init_state(seed=7)`` draws,
    gathered whole; and on those saved params ``make_serve_fns``' prefill
    of ``serve``'s tokens and one decode step of its next tokens, their
    logits gathered whole."""
    from repro_torch.configs import get_bundle
    from repro_torch.distributed.fsdp import full_tensor
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models.api import ShapeSpec
    from repro_torch.models.common import tree_map
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      make_serve_fns, make_train_step)

    f32_activations()
    mesh = make_small_mesh(world, 1, device_type="cpu")
    results = []
    for arch, batches in cases:
        bundle = get_bundle(arch, reduced=True)
        step_fn, init_state = make_train_step(bundle, TrainStepConfig(
            opt=AdamWConfig(**cfg_kw), grad_compression=True), "cpu", mesh=mesh)
        state = init_state(params=torch.load(tmp / f"{arch}.pt"))
        out = {"loss": [], "grad_norm": []}
        for batch in batches:
            state, m = step_fn(state, batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        out.update(_state_out(state))
        out["seed_init"] = tree_map(full_tensor, init_state(seed=7)["params"])
        toks, nxt = serve
        b, s = toks.shape
        params = torch.load(tmp / f"{arch}.pt")
        fn, _ = make_serve_fns(bundle, mesh, ShapeSpec("p", s, b, "prefill"), "cpu")
        logits, cache = fn(params, {"tokens": toks}, max_len=s + 1)
        dfn, _ = make_serve_fns(bundle, mesh, ShapeSpec("d", s + 1, b, "decode"), "cpu")
        dl, _ = dfn(params, cache, nxt, s)
        out["serve"] = [logits.full_tensor(), dl.full_tensor()]
        results.append(out)
    return {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
            "cases": results}


def check_local_slices(ranks: list, specs, sizes: dict) -> None:
    """Each rank's blocks (``out["local"]``) of params, moments and
    residual are its ``local_slices`` under ``specs`` of the whole state it
    gathered (``out["whole"]``), and every rank gathered the same whole;
    ``ranks`` holds (coordinate, out) pairs."""
    from repro_torch.distributed.fsdp import spec_leaves
    from repro_torch.distributed.sharding import local_slices
    from repro_torch.models.common import tree_flatten

    leaves = spec_leaves(specs)
    first = ranks[0][1]["whole"]
    for coord, out in ranks:
        for key, tree in out["local"].items():
            wholes = tree_flatten(out["whole"][key])[0]
            blocks = tree_flatten(tree)[0]
            assert len(blocks) == len(wholes) == len(leaves), key
            for i, (block, whole, same, spec) in enumerate(zip(
                    blocks, wholes, tree_flatten(first[key])[0], leaves)):
                assert torch.equal(whole, same), (key, i)
                assert torch.equal(block, whole[local_slices(
                    tuple(whole.shape), spec, sizes, coord)]), (key, i, spec)


def unit_scores(params, cfg):
    """The params with wq and wk scaled by sqrt(H/d) and sqrt(KV/d): unit-
    variance attention scores (chip_smoke.py's ``conditioned``; the init's
    fan-in of wq [d,H,hd] is H, which puts the scores near an argmax).
    Elementwise, so a block of the result is the result of the block; the
    leaves may be DTensors.  Shares every other tensor with ``params``."""
    attn = dict(params["blocks"]["attn"])
    attn["wq"] = attn["wq"] * (cfg.n_heads / cfg.d_model) ** 0.5
    attn["wk"] = attn["wk"] * (cfg.n_kv / cfg.d_model) ** 0.5
    return {**params, "blocks": {**params["blocks"], "attn": attn}}


def tp_serve_case(rank, world, tmp, data, model, cases):
    """``make_serve_fns`` on a data ``data`` x model ``model`` mesh in
    float32 (``f32_serving``): per case the sharded init
    (``init_serving_params``), a prefill and decode steps with those
    DTensors on unit-variance scores (``unit_scores``), the same prefill
    with the whole params (``case["whole"]``, so conditioned), and a spy on every
    ``constrain`` call of the models (kind, the global shape that
    ``activation_spec`` was given, the local block that came out)."""
    from repro_torch.distributed import context
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import transformer, transformer_serve
    from repro_torch.models.api import ShapeSpec, bundle_for
    from repro_torch.models.common import tree_map
    from repro_torch.training import init_serving_params, make_serve_fns

    f32_serving(transformer_serve, transformer.embed_tokens, torch.float32)
    mesh = make_small_mesh(data, model, device_type="cpu")
    seen: list = []
    spec_fn, constrain_fn = context.activation_spec, transformer.constrain

    def spec_spy(shape, kind, sizes):
        seen.append([kind, tuple(shape)])
        return spec_fn(shape, kind, sizes)

    def constrain_spy(x, kind, *args, **kw):
        out = constrain_fn(x, kind, *args, **kw)
        seen[-1].append(tuple(out.shape))
        return out

    context.activation_spec = spec_spy
    transformer.constrain = constrain_spy
    results = []
    for case in cases:
        bundle = bundle_for(case["arch"], case["cfg"])
        batch, nxt = case["batch"], case["next"]
        b, s = batch["tokens"].shape
        s += case["cfg"].prefix_tokens if "prefix_embeds" in batch else 0
        params = init_serving_params(
            bundle, mesh, torch.Generator().manual_seed(case["seed"]), "cpu",
            torch.float32)
        init = tree_map(lambda t: t.to_local(), params)
        params = unit_scores(params, case["cfg"])
        fn, _ = make_serve_fns(bundle, mesh, ShapeSpec("p", s, b, "prefill"), "cpu")
        whole_logits, _ = fn(torch.load(tmp / case["whole"]), batch,
                             max_len=case["max_len"])
        del seen[:]
        logits, cache = fn(params, batch, max_len=case["max_len"])
        out = {"init": init,
               "prefill": logits.full_tensor(),
               "prefill_whole_params": whole_logits.full_tensor(),
               "prefill_cache": tree_map(lambda t: t.full_tensor(), cache),
               "prefill_spy": [tuple(x) for x in seen]}
        dfn, _ = make_serve_fns(bundle, mesh, ShapeSpec(
            "d", case["max_len"], b, "decode"), "cpu")
        out["decode"], out["decode_spy"] = [], []
        for i, tok in enumerate(nxt):
            del seen[:]
            dl, cache = dfn(params, cache, tok, s + i)
            out["decode"].append(dl.full_tensor())
            out["decode_spy"].append([tuple(x) for x in seen])
        out["cache"] = tree_map(lambda t: t.full_tensor(), cache)
        out["cache_local"] = tree_map(lambda t: t.to_local(), cache)
        out["logits_local"] = dl.to_local()
        out.update(_tp_forward(mesh, case, params, seen))
        results.append(out)
    return {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
            "cases": results}


def _tp_forward(mesh, case, params, seen):
    """``embed_tokens`` (+ ``embed_prefix``) and ``forward_hidden`` on this
    rank's blocks in its tensor-parallel region, in float32 and without
    grad: the result gathered over S (``hidden``, the rank's batch rows
    ``hidden_rows``) and the spy's record of the ``constrain`` calls."""
    from repro_torch.distributed.context import gather_seq, tensor_parallel
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_map
    from repro_torch.training.train_step import _MeshPlace

    place = _MeshPlace(mesh)
    cfg, batch = case["cfg"], case["batch"]
    b, s_text = batch["tokens"].shape
    region = place.region(b)
    rows = b // region.batch_split
    r0 = rows * (place.coord.get("data", 0) if region.batch_split > 1 else 0)
    blocks = tree_map(lambda t: t.to_local(), params)
    s = s_text + (cfg.prefix_tokens if "prefix_embeds" in batch else 0)
    del seen[:]
    with torch.no_grad(), tensor_parallel(region):
        x = transformer.embed_tokens(blocks, cfg, batch["tokens"][r0:r0 + rows],
                                     compute_dtype=torch.float32)
        if "prefix_embeds" in batch:
            x = transformer.embed_prefix(
                blocks, batch["prefix_embeds"][r0:r0 + rows], x, seq=s_text)
        h = transformer.forward_hidden(blocks, cfg, x, seq=s)
        h = gather_seq(h, s)
    return {"hidden": h, "hidden_rows": (r0, r0 + rows),
            "forward_spy": [tuple(x) for x in seen]}


# --------------------------------------------------------------------------- #
# tensor-parallel training
# --------------------------------------------------------------------------- #
TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=20)


def tp_train_case(rank, world, tmp, data, model, cases):
    """``make_train_step`` on a data ``data`` x model ``model`` mesh with
    int8 gradients, float32 activations (``f32_activations``), per case:
    the step-0 loss and gradients gathered whole (:func:`whole_grads`),
    three steps' losses and grad norms, and after them the state gathered
    whole and this rank's blocks of it; on the last mesh case also a
    checkpoint of the state (``ckpt``, the whole tree, rank 0 writing)."""
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models.api import bundle_for
    from repro_torch.training import AdamWConfig, TrainStepConfig, make_train_step

    f32_activations()
    mesh = make_small_mesh(data, model, device_type="cpu")
    results = []
    for case in cases:
        bundle = bundle_for(case["arch"], case["cfg"])
        step_fn, init_state = make_train_step(bundle, TrainStepConfig(
            opt=AdamWConfig(**TRAIN_OPT), grad_compression=True), "cpu", mesh=mesh)
        state = init_state(params=torch.load(tmp / case["whole"]))
        loss, grads = whole_grads(step_fn, state, case["batches"][0], mesh)
        out = {"loss0": float(loss), "grads": grads, "loss": [], "grad_norm": []}
        for batch in case["batches"]:
            state, m = step_fn(state, batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        out.update(_state_out(state))
        if case.get("ckpt"):
            save(tmp / "ckpt", 3, state)
        results.append(out)
    return {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
            "cases": results}


def compress_case(rank, world, tmp, leaves):
    """On a data 2 x model 2 mesh: per (global g, residual r, spec) of
    ``leaves``, this rank's blocks through ``compress_grads_int8`` with the
    group that splits the rows (``LeafLayout.row_group``), and through
    ``row_absmax`` + MAX + ``quantize_int8(absmax=)`` directly."""
    import torch.distributed as dist

    from repro_torch.distributed.fsdp import LeafLayout
    from repro_torch.distributed.sharding import local_slices, mesh_shape
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.training import compress_grads_int8

    mesh = make_small_mesh(2, 2, device_type="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for g, r, spec in leaves:
        sl = local_slices(tuple(g.shape), spec, mesh_shape(mesh), coord)
        lay = LeafLayout(tuple(g.shape), spec, mesh)
        group = lay.row_group()
        gl, rl = g[sl].clone(), r[sl].clone()
        deq, res = compress_grads_int8([gl], [rl.clone()], [group])
        flat = (gl + rl).reshape(-1, gl.shape[-1])
        amax = ops.row_absmax(flat)
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale = ops.quantize_int8(flat, absmax=amax)
        out.append({"slices": sl, "deq": deq[0], "residual": res[0], "q": q,
                    "scale": scale, "split": group is not None})
    return out


def train_launch_case(rank, world, tmp, argv):
    """``launch/train.main(argv)`` on this process group; its result, or
    the code it exited with."""
    from repro_torch.launch import train

    try:
        return {"result": train.main(argv)}
    except SystemExit as e:
        return {"exit": e.code}
