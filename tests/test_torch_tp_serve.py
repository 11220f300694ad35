"""Tensor-parallel serving of the dense transformers, on the CPU.

``make_serve_fns`` on meshes of data 1 x model 2, 1 x 4 and 2 x 2, one gloo
process a device (``_torch_dist_workers.tp_serve_case``), in float32: both
packages' ``transformer_serve`` embed in float32 and prefill float32 caches
(``f32_serving``), so the comparison is the algorithm's.  The reduced
configs cover every layout the policy gives: kv heads over "model"
(llama3-8b at model 2, stablelm-3b's H = KV = 4 at model 4), H dividing
and KV not, so the cache shards the sequence (llama3-8b and gemma2-9b's
window of 16 and soft-caps at model 4), neither dividing, so the heads run
whole on every rank (deepseek-coder-33b at model 2, internvl2-1b at model 4
with its modality prefix), a vocabulary that does not divide the axis
(llama3-8b's vocab replaced by 511 on both sides), Command-R's parallel
block, and prompts that the axis does not divide (``hidden`` replicated in
the prefill); on 2 x 2 the batch splits over "data" where it divides.

For each case: the gathered logits of the prefill and of 3 decode steps,
and the caches (``full_tensor``), against the one-process port and the
reference's ``bundle.prefill`` / ``bundle.decode`` on the same weights, at
1e-5 of the logit (or cache) scale, on unit-variance attention scores
(``unit_scores``, chip_smoke.py's ``conditioned``: the init puts the scores
near an argmax, where float32 reassociation between two correct
computations grows over the layers, to 1.8e-5 of the logit scale between
the one-process port and the reference before any tensor parallelism; on
unit-variance scores that gap is 3e-7 to 1.7e-6); each rank's blocks of the caches and
the logits exactly ``local_slices``' blocks of the whole under
``cache_pspecs`` and the reference's logits spec; the sharded init
(``init_serving_params``) bit for bit ``local_slices`` of the whole init
under ``serving_pspecs``; and a spy: the (kind, global shape) of every
``constrain`` call of the port's models, in order, is the sequence the
reference's ``constrain`` passes to a monkeypatched
``with_sharding_constraint`` (which traces its scanned layer body once a
call: one layer's sequence, which the port runs once a layer), with the
reference's spec, and each rank's block has the shard shape of that spec.  The reference runs outside any
mesh (jax 0.9 refuses ``with_sharding_constraint`` inside one); for the spy
it runs under an ``AbstractMesh`` of the same shape.  The loss's forward
(``embed_tokens``, the prefix, ``forward_hidden``) runs on each rank's
blocks in its region too, against both at 1e-5, with the same spy.

K3's partial form on the CPU: the plain version over 2 and 4 slot ranges
(slot 0 at ``start``), merged by ``combine_partials``, equals the plain
version over the whole cache and the reference's ``decode_attention_ref``
at 1e-6, with a window across a range boundary, a range with no valid slot
and ``cur_len`` per row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.distributed.context as jax_context
import repro.models.transformer as jax_transformer
import repro.models.transformer_serve as jax_serve
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ref as jax_ref
from repro.models.api import bundle_for as jax_bundle_for
from repro_torch.configs import get_reduced
from repro_torch.distributed import activation_spec, cache_pspecs
from repro_torch.distributed.sharding import local_slices, shard_shape, spec_at
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention_plain)
from repro_torch.models import transformer, transformer_serve
from repro_torch.models.api import bundle_for
from repro_torch.models.common import tree_flatten
from repro_torch.training.train_step import serving_pspecs

import _torch_dist_workers as workers

TOL = 1e-5
STEPS = 3
# mesh: [(case id, arch, batch, prompt length, cache length, vocab)]
MESHES = {
    (1, 2): [("kv-heads", "llama3-8b", 2, 12, 16, None),
             ("parallel-block", "command-r-plus-104b", 2, 12, 16, None),
             ("whole-heads", "deepseek-coder-33b", 2, 12, 16, None),
             ("vocab-511-ragged", "llama3-8b", 1, 9, 16, 511)],
    (1, 4): [("mha-kv-heads", "stablelm-3b", 1, 8, 16, None),
             ("seq-cache", "llama3-8b", 2, 12, 16, None),
             ("window-softcap", "gemma2-9b", 2, 20, 24, None),
             ("prefix-whole-heads", "internvl2-1b", 2, 20, 24, None),
             ("ragged", "llama3-8b", 2, 10, 16, None)],
    (2, 2): [("batch-split", "llama3-8b", 4, 12, 16, None),
             ("batch-whole", "command-r-plus-104b", 3, 8, 16, None)],
}
CASES = [(m, c[0]) for m, cases in MESHES.items() for c in cases]
IDS = [f"{m[0]}x{m[1]}-{c}" for m, c in CASES]


def _cfgs(arch, vocab):
    t, j = get_reduced(arch), jax_get_reduced(arch)
    if vocab:
        t, j = dataclasses.replace(t, vocab=vocab), dataclasses.replace(j, vocab=vocab)
    return t, j


def _case(i, arch, b, s, max_len, vocab, tmp):
    """Inputs from a seed with numpy; the whole float32 init saved for the
    workers' whole-params prefill."""
    cfg, _ = _cfgs(arch, vocab)
    rng = np.random.default_rng(100 + i)
    pre = cfg.prefix_tokens
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s - pre),
                                                    dtype=np.int32))}
    if pre:
        batch["prefix_embeds"] = torch.as_tensor(rng.standard_normal(
            (b, pre, cfg.prefix_dim), dtype=np.float32))
    nxt = [torch.as_tensor(rng.integers(0, cfg.vocab, (b,), dtype=np.int32))
           for _ in range(STEPS)]
    whole = bundle_for(arch, cfg).init(torch.Generator().manual_seed(i), "cpu",
                                       torch.float32)
    torch.save(workers.unit_scores(whole, cfg), tmp / f"whole{i}.pt")
    return dict(arch=arch, cfg=cfg, batch=batch, next=nxt, max_len=max_len,
                seed=i, whole=f"whole{i}.pt"), whole


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _f32_both():
    """Float32 serving in both packages (restored after)."""
    saved = [(m, n, getattr(m, n)) for m in (transformer_serve, jax_serve)
             for n in ("embed_tokens", "prefill")]
    workers.f32_serving(transformer_serve, transformer.embed_tokens, torch.float32)
    workers.f32_serving(jax_serve, jax_transformer.embed_tokens, jnp.float32)
    return saved


def _reference(arch, vocab, whole, case, sizes):
    """The reference's prefill and decode steps on the same weights, under
    an AbstractMesh of ``sizes`` for the spy (``with_sharding_constraint``
    records and passes its input through)."""
    _, jcfg = _cfgs(arch, vocab)
    jb = jax_bundle_for(arch, jcfg)
    params = _jax_tree(whole)
    seen = []
    real = jax.lax.with_sharding_constraint

    def spy(x, sh):
        seen.append((tuple(x.shape), sh.spec))
        return x

    batch = {k: jnp.asarray(v.numpy()) for k, v in case["batch"].items()}
    b, s = case["batch"]["tokens"].shape
    s += case["cfg"].prefix_tokens
    jax.lax.with_sharding_constraint = spy
    try:
        with jax_context.activation_mesh(AbstractMesh(tuple(sizes.values()),
                                                      tuple(sizes))):
            logits, cache = jb.prefill(params, batch, max_len=case["max_len"])
            out = {"prefill": np.asarray(logits), "prefill_spy": list(seen),
                   "prefill_cache": jax.tree_util.tree_map(np.asarray, cache),
                   "decode": [], "decode_spy": []}
            for i, tok in enumerate(case["next"]):
                del seen[:]
                logits, cache = jb.decode(params, cache, jnp.asarray(tok.numpy()),
                                          jnp.asarray(s + i, jnp.int32))
                out["decode"].append(np.asarray(logits))
                out["decode_spy"].append(list(seen))
            # the loss's forward: the embedding, the prefix, forward_hidden
            del seen[:]
            x = jax_transformer.embed_tokens(params, jcfg, batch["tokens"],
                                             compute_dtype=jnp.float32)
            if "prefix_embeds" in batch:
                x = jnp.concatenate([batch["prefix_embeds"] @ params["prefix_proj"],
                                     x], axis=1)
            out["hidden"] = np.asarray(jax_transformer.forward_hidden(
                params, jcfg, x, remat=False))
            out["forward_spy"] = list(seen)
    finally:
        jax.lax.with_sharding_constraint = real
    out["cache"] = jax.tree_util.tree_map(np.asarray, cache)
    return out


def _one_process(arch, vocab, whole, case):
    cfg, _ = _cfgs(arch, vocab)
    bundle = bundle_for(arch, cfg)
    logits, cache = bundle.prefill(whole, case["batch"], case["max_len"])
    out = {"prefill": logits, "decode": [],
           "prefill_cache": {g: {k: v.clone() for k, v in t.items()}
                             for g, t in cache.items()}}
    b, s = case["batch"]["tokens"].shape
    s += cfg.prefix_tokens
    for i, tok in enumerate(case["next"]):
        logits, cache = bundle.decode(whole, cache, tok, s + i)
        out["decode"].append(logits)
    out["cache"] = cache
    with torch.no_grad():
        x = transformer.embed_tokens(whole, cfg, case["batch"]["tokens"],
                                     compute_dtype=torch.float32)
        if "prefix_embeds" in case["batch"]:
            x = transformer.embed_prefix(whole, case["batch"]["prefix_embeds"], x)
        out["hidden"] = transformer.forward_hidden(whole, cfg, x)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh: the workers' results, the one-process port's and the
    reference's, per case."""
    saved = _f32_both()
    try:
        out, started = {}, {}
        for mesh, specs in MESHES.items():
            tmp = tmp_path_factory.mktemp(f"tp{mesh[0]}x{mesh[1]}")
            cases = [_case(i, *spec[1:], tmp) for i, spec in enumerate(specs)]
            started[mesh] = (tmp, cases, workers.start(
                workers.tp_serve_case, mesh[0] * mesh[1], tmp, mesh[0], mesh[1],
                [c for c, _ in cases]))
        # the one-process runs while the workers run
        for mesh, specs in MESHES.items():
            sizes = {"data": mesh[0], "model": mesh[1]}
            out[mesh] = {}
            for (cid, arch, *_s, vocab), (case, whole) in zip(specs, started[mesh][1]):
                held = workers.unit_scores(whole, case["cfg"])
                out[mesh][cid] = dict(
                    case=case, whole=whole, sizes=sizes,
                    port=_one_process(arch, vocab, held, case),
                    ref=_reference(arch, vocab, held, case, sizes))
        for mesh, specs in MESHES.items():
            tmp, _, procs = started[mesh]
            ranks = workers.finish(procs, tmp)
            for i, (cid, *_rest) in enumerate(specs):
                out[mesh][cid]["ranks"] = [(r["coord"], r["cases"][i]) for r in ranks]
        yield out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _close(got, want, scale, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _leaves(tree):
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_logits_match_one_process_and_reference(runs, mesh, cid):
    r = runs[mesh][cid]
    scale = float(r["port"]["prefill"].abs().max())
    _close(r["port"]["prefill"], r["ref"]["prefill"], scale, "port vs ref prefill")
    for _, out in r["ranks"]:
        for key in ("prefill", "prefill_whole_params"):
            _close(out[key], r["port"]["prefill"], scale, key)
            _close(out[key], r["ref"]["prefill"], scale, key)
        for step, (got, port, ref) in enumerate(zip(
                out["decode"], r["port"]["decode"], r["ref"]["decode"])):
            _close(got, port, scale, f"decode {step}")
            _close(got, ref, scale, f"decode {step} vs ref")


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_caches_match_one_process_and_reference(runs, mesh, cid):
    r = runs[mesh][cid]
    for _, out in r["ranks"]:
        for key in ("prefill_cache", "cache"):
            for got, port, ref in zip(_leaves(out[key]), _leaves(r["port"][key]),
                                      jax.tree_util.tree_leaves(r["ref"][key])):
                scale = float(np.abs(ref).max())
                _close(got, port, scale, key)
                _close(got, ref, scale, f"{key} vs ref")


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_rank_blocks_are_local_slices(runs, mesh, cid):
    """Each rank's cache blocks and logits block are exactly the blocks of
    the gathered whole under ``cache_pspecs`` and the logits spec."""
    r = runs[mesh][cid]
    case, sizes = r["case"], r["sizes"]
    bundle = bundle_for(case["arch"], case["cfg"])
    b = case["batch"]["tokens"].shape[0]
    specs = cache_pspecs(bundle.cache_spec(b, case["max_len"]), sizes,
                         family="transformer")
    dp = "data" if b % sizes["data"] == 0 and sizes["data"] > 1 else None
    logits_spec = (("data",) if dp else None,
                   "model" if case["cfg"].vocab % sizes["model"] == 0 else None)
    for coord, out in r["ranks"]:
        for group, tree in out["cache_local"].items():
            for name, local in tree.items():
                whole = out["cache"][group][name]
                spec = specs[group][name]
                assert torch.equal(local, whole[local_slices(
                    tuple(whole.shape), spec, sizes, coord)]), (group, name)
        last = out["decode"][-1]
        assert torch.equal(out["logits_local"], last[local_slices(
            tuple(last.shape), logits_spec, sizes, coord)])


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_sharded_init_is_local_slices_of_the_whole_init(runs, mesh, cid):
    r = runs[mesh][cid]
    case, sizes = r["case"], r["sizes"]
    specs = serving_pspecs(bundle_for(case["arch"], case["cfg"]), sizes)

    def walk(local, whole, path):
        if isinstance(whole, dict):
            for k in whole:
                walk(local[k], whole[k], f"{path}/{k}" if path else k)
            return
        spec = spec_at(specs, path)
        want = whole[local_slices(tuple(whole.shape), spec, sizes, coord)]
        assert local.dtype == want.dtype and torch.equal(local, want), path

    for coord, out in r["ranks"]:
        walk(out["init"], r["whole"], "")


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_constrain_points_match_reference(runs, mesh, cid):
    """The reference scans its layers, so it traces (and records) one
    layer's body a call; the port runs the same points once a layer."""
    r = runs[mesh][cid]
    sizes, n_layers = r["sizes"], r["case"]["cfg"].n_layers
    for _, out in r["ranks"]:
        pairs = [(out["prefill_spy"], r["ref"]["prefill_spy"])]
        pairs += list(zip(out["decode_spy"], r["ref"]["decode_spy"]))
        for mine, ref in pairs:
            _same_points(mine, ref * n_layers, sizes)


def _same_points(mine, ref, sizes):
    """The port's spy record (kind, global shape, local block) against the
    reference's (global shape, spec), call by call."""
    assert len(mine) == len(ref) > 0
    for (kind, shape, local), (ref_shape, ref_spec) in zip(mine, ref):
        assert shape == ref_shape, (kind, shape, ref_shape)
        spec = activation_spec(shape, kind, sizes)
        assert P(*spec) == ref_spec, (kind, shape, spec, ref_spec)
        assert local == shard_shape(shape, spec, sizes), (kind, shape, local)


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_forward_hidden_in_a_region(runs, mesh, cid):
    """The loss's forward (``embed_tokens``, the prefix, ``forward_hidden``)
    on a rank's blocks in its region: the hidden states gathered over S
    equal the one-process port's and the reference's at 1e-5 of their
    scale, and the ``constrain`` points are the reference's (its entry,
    then its scanned body, which it records once, once a layer)."""
    r = runs[mesh][cid]
    port, ref = r["port"]["hidden"], r["ref"]["hidden"]
    scale = float(port.abs().max())
    _close(port, ref, scale, "port vs ref hidden")
    spy = r["ref"]["forward_spy"]
    want = spy[:1] + spy[1:] * r["case"]["cfg"].n_layers
    for _, out in r["ranks"]:
        lo, hi = out["hidden_rows"]
        _close(out["hidden"], port[lo:hi], scale, "hidden")
        _close(out["hidden"], ref[lo:hi], scale, "hidden vs ref")
        _same_points(out["forward_spy"], want, r["sizes"])


# --------------------------------------------------------------------------- #
# K3's partial form (plain version)
# --------------------------------------------------------------------------- #
K3_CASES = {  # id: (b, s, h, kv, hd, cur_len, window, cap)
    "window-across-a-boundary": (2, 48, 8, 2, 16, [40, 30], 12, 0.0),
    "empty-range-softcap": (2, 48, 8, 2, 16, 9, 0, 30.0),
    "ragged-cur-len": (3, 64, 4, 1, 8, [1, 33, 64], 0, 0.0),
    "ragged-window-mha": (3, 64, 4, 4, 8, [7, 50, 64], 20, 20.0),
}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("cid", list(K3_CASES))
def test_decode_partial_form_combines_to_the_whole(cid, ranks):
    b, s, h, kv, hd, cur, window, cap = K3_CASES[cid]
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    cur_len = torch.tensor(cur, dtype=torch.int32)
    n = s // ranks
    parts = [decode_attention_plain(q, k[:, r * n:(r + 1) * n],
                                    v[:, r * n:(r + 1) * n], cur_len,
                                    window=window, logit_cap=cap, start=r * n,
                                    return_lse=True) for r in range(ranks)]
    lse = torch.stack([p[1] for p in parts])
    empty = torch.isinf(lse)
    assert empty.any() if cid != "ragged-window-mha" or ranks == 4 else True
    assert not torch.stack([p[0] for p in parts])[empty].any()
    got = combine_partials(torch.stack([p[0] for p in parts]), lse)
    whole = decode_attention_plain(q, k, v, cur_len, window=window, logit_cap=cap)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    ref = jax_ref.decode_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy()), jnp.asarray(cur),
                                       window=window, logit_cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cid", list(K3_CASES))
def test_decode_partial_lse_is_the_logsumexp(cid):
    """The plain version's lse over one range is log sum exp of its valid
    scaled (soft-capped) scores, computed directly in float64."""
    b, s, h, kv, hd, cur, window, cap = K3_CASES[cid]
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    start, n = s // 4, s // 2
    _, lse = decode_attention_plain(q, k[:, start:start + n], v[:, start:start + n],
                                    torch.tensor(cur), window=window,
                                    logit_cap=cap, start=start, return_lse=True)
    qg = q.double().reshape(b, kv, h // kv, hd) * hd ** -0.5
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k[:, start:start + n].double())
    if cap:
        sc = cap * torch.tanh(sc / cap)
    pos = start + torch.arange(n)
    c = torch.as_tensor(cur).reshape(-1, 1)
    valid = (pos < c) & ((pos > c - 1 - window) if window else True)
    sc = sc.masked_fill(~valid.expand(b, n)[:, None, None, :], -torch.inf)
    want = torch.logsumexp(sc, dim=-1).reshape(b, h)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    np.testing.assert_allclose(lse[fin].numpy(), want[fin].numpy(), atol=1e-5,
                               rtol=1e-6)


# --------------------------------------------------------------------------- #
# the heads a rank runs, and the sharded init's keeper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("h,kv,tp", [
    (4, 2, 2), (4, 2, 4), (4, 4, 4), (6, 2, 2), (7, 1, 2), (96, 8, 4),
    (14, 2, 4), (32, 8, 4), (56, 8, 4), (16, 8, 4)])
def test_local_heads_cover_each_head_once(h, kv, tp):
    """Every rank's query heads read exactly its contiguous kv slice (head
    q reads kv head q // (H / KV)); the ranks' query heads tile H once where
    H divides the axis, else every rank runs all of them."""
    from repro_torch.distributed.sharding import local_heads

    g = h // kv
    seen = []
    for r in range(tp):
        lh = local_heads(h, kv, tp, r)
        qs = range(lh.q0, lh.q0 + lh.h)
        assert sorted({q // g for q in qs}) == list(range(lh.kv0, lh.kv0 + lh.kv))
        assert lh.h % lh.kv == 0
        assert lh.q_sharded == (h % tp == 0) and lh.kv_sharded == (kv % tp == 0)
        seen += list(qs)
    assert sorted(seen) == sorted(list(range(h)) * (1 if h % tp == 0 else tp))


def test_local_heads_refuse_heads_that_do_not_nest():
    from repro_torch.distributed.sharding import local_heads

    with pytest.raises(ValueError, match="do not nest"):
        local_heads(12, 2, 3, 0)                # 4 a rank, groups of 6


def test_block_keeper_keeps_a_copy_of_the_block():
    """A sharded leaf's block is a copy (the whole can be freed), equal to
    ``local_slices``' block; a layer of a stacked leaf takes the spec
    without its layer entry; a leaf the rank holds whole comes back as it
    is."""
    from repro_torch.distributed.sharding import block_keeper

    sizes = {"data": 1, "model": 4}
    specs = {"embed": ("model", None), "final_norm": {"scale": (None,)},
             "blocks": {"wq": (None, None, "model", None)}}
    keep = block_keeper(specs, sizes, {"data": 0, "model": 2})
    emb = torch.arange(32.0).reshape(8, 4)
    got = keep("embed", emb)
    assert torch.equal(got, emb[4:6]) and got.untyped_storage().data_ptr() != \
        emb.untyped_storage().data_ptr()
    scale = torch.ones(4)
    assert keep("final_norm/scale", scale) is scale
    wq = torch.arange(64.0).reshape(2, 8, 4)
    assert torch.equal(keep("blocks/wq", wq, stacked=True), wq[:, 4:6])
