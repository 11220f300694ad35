"""Sharding policy: FSDP × TP × (pod) DP over the production mesh.

The reference's ``distributed/sharding.py`` without JAX.  One function —
:func:`param_pspecs` — maps every parameter leaf to a spec by (path, shape)
pattern; :func:`input_pspecs` / :func:`cache_pspecs` do the same for step
inputs and serving caches.

Policy (the reference's):
  * batch-like axes        → dp = ("pod", "data") (or ("data",) single-pod)
  * attention heads, FFN hidden, MoE experts, vocab → "model" (Megatron TP),
    only when the axis size divides the mesh axis — otherwise that axis is
    left unsharded (e.g. deepseek-coder's 56 heads on a 16-wide TP axis)
  * one more large axis of every ≥2-D weight → dp (FSDP)
  * decode KV caches       → kv-head axis over "model" when divisible, else
    the SEQUENCE axis over "model" (distributed flash-decoding layout)

**Specs.**  A spec is a tuple with one entry per tensor dim, as the entries
of the reference's ``PartitionSpec``: ``None``, an axis name, or a tuple of
axis names (several mesh axes on one tensor dim, major to minor).  The
policy writes the reference's entries as its source writes them (``embed``
→ ``("model", ("data",))``).  In spec trees the specs are the leaves:
containers are dicts and lists only.

**Meshes.**  The policy reads axis names and sizes only, so every function
here takes a mesh *shape*: an ordered mapping of axis names to sizes (e.g.
``{"data": 16, "model": 16}``), or a ``DeviceMesh`` whose dims are named,
read through :func:`mesh_shape`.  The production shapes (16×16, 2×16×16)
need no devices.

**Placements.**  :func:`placements` turns a spec into DTensor placements on
a ``DeviceMesh`` (one per *mesh* dim: ``Shard(d)`` where a spec entry names
that axis, else ``Replicate()``).  An entry with several axes, e.g.
``("model", "data")`` on a ``(data, model)`` mesh, shards one tensor dim
over both: the shard shapes are the reference's, but DTensor splits in
mesh-dim order (data major, model minor) where the reference's spec order
puts "model" major.  The port keeps DTensor's order: the rank at mesh
coordinates ``c`` holds block ``sum_i c[a_i] * prod(sizes after a_i)``
over that dim's axes ``a_i`` in mesh order (:func:`local_slices`), where
the reference's device at ``c`` holds the block of the spec's order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

__all__ = ["TP", "LocalHeads", "batch_axes", "block_keeper", "cache_pspecs",
           "dp_axes", "input_pspecs", "local_heads", "local_slices", "mesh_shape",
           "param_pspecs", "placements", "shard_shape", "strip_dp",
           "tree_placements"]

TP = "model"


def mesh_shape(mesh: Any) -> dict[str, int]:
    """The ordered ``{axis name: size}`` of a mesh shape or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the policy needs a mesh with named dims")
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh: Any) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _div(n: int, mesh: Any, axis=TP) -> bool:
    shape = mesh_shape(mesh)
    return n % math.prod(shape[a] for a in _axes(axis)) == 0


def batch_axes(n: int, mesh: Any):
    """dp axes for a batch-like dim — None when the batch doesn't divide
    (e.g. long_500k's global_batch=1 decodes with batch replicated)."""
    dp = dp_axes(mesh)
    return dp if _div(n, mesh, dp) else None


# --------------------------------------------------------------------------- #
# trees of specs
# --------------------------------------------------------------------------- #
def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (path: the keys and
    list indices as strings, the reference's ``DictKey`` / ``SequenceKey``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree)]
    return fn(path, tree)


def _map_specs(fn, specs):
    """``fn(spec)`` over a spec tree (tuples are the leaves)."""
    return _map_with_path(lambda _, s: fn(s), specs)


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _leaf_spec(path: str, shape: tuple[int, ...], mesh: Any) -> tuple:
    """FSDP × TP placement with one invariant: the dp (FSDP) axes NEVER land
    on a weight dim that the forward pass contracts (sharding a contracting
    dim makes the partitioner psum activation-sized partial products instead
    of all-gathering weight shards).  FSDP therefore rides the OUTPUT dims —
    jointly with TP when divisibility allows, alone otherwise, and weights
    replicate across dp as the last resort (small archs only)."""
    sizes = mesh_shape(mesh)
    dp = dp_axes(sizes)
    dims = len(shape)

    def tp_ok(n: int) -> bool:
        return _div(n, sizes)

    def out_sharding(n_out: int, want_tp: bool):
        """Best sharding for a forward-OUTPUT weight dim."""
        if want_tp and tp_ok(n_out):
            for extra in (dp, ("data",)):
                if n_out % math.prod(sizes[a] for a in (TP, *extra)) == 0:
                    return (TP, *extra)
            return TP
        for extra in (dp, ("data",)):
            if _div(n_out, sizes, extra):
                return extra
        return None

    # "blocks"/"groups" are weight-stacked (leading layer axis);
    # "lead_blocks"/"tail" are plain per-layer lists (no stack axis)
    stacked = path.startswith(("blocks", "groups"))
    off = 1 if (stacked and dims >= 3) else 0  # leading layer-stack axis

    # ---- embeddings / head ----
    if path.endswith("embed"):
        # lookup gathers rows: both dims are "output-like"
        return (TP if tp_ok(shape[0]) else None,
                dp if _div(shape[1], sizes, dp) else None)
    if path.endswith("head"):
        # h @ W: contracts d (dim 0) — keep it unsharded
        return (None, out_sharding(shape[1], want_tp=True))
    if path.endswith("prefix_proj"):
        return (None, TP if tp_ok(shape[1]) else None)

    # ---- norms / small vectors ----
    if dims - off <= 1 or any(k in path for k in
                              ("ln", "norm", "bias", "A_log", "dt_bias",
                               "lam", "conv_b", "D")):
        return (None,) * dims

    name = path.rsplit("/", 1)[-1]

    # ---- attention projections ----
    if name in ("wq", "wk", "wv"):
        # [*, d, H, hd]: contracts d.  TP on heads; FSDP on head_dim.
        h_idx, hd_idx = off + 1, off + 2
        spec = [None] * dims
        spec[h_idx] = TP if tp_ok(shape[h_idx]) else None
        if _div(shape[hd_idx], sizes, dp):
            spec[hd_idx] = dp
        return tuple(spec)
    if name == "wo" and dims - off == 3:
        # [*, H, hd, d]: contracts (H, hd).  TP on heads; FSDP on d.
        spec = [None] * dims
        spec[off] = TP if tp_ok(shape[off]) else None
        if _div(shape[off + 2], sizes, dp):
            spec[off + 2] = dp
        return tuple(spec)
    if name in ("wuk", "wuv"):
        # [*, lora, H, dim]: contracts lora.  TP on heads; FSDP on dim.
        spec = [None] * dims
        spec[off + 1] = TP if tp_ok(shape[off + 1]) else None
        if _div(shape[off + 2], sizes, dp):
            spec[off + 2] = dp
        return tuple(spec)
    if name in ("wdkv", "wkr"):
        # [*, d, lora]: contracts d; lora is tiny — FSDP it when possible
        return (None,) * (dims - 1) + (dp if _div(shape[-1], sizes, dp) else None,)

    # ---- MoE experts [*, E, d_in, f] / [*, E, f, d_out] ----
    if "experts" in path:
        spec = [None] * dims
        spec[off] = TP if tp_ok(shape[off]) else None
        # FSDP the LAST dim (the per-expert output dim for wi/wg; for wo it
        # is d_out — also an output)
        if _div(shape[-1], sizes, dp):
            spec[-1] = dp
        return tuple(spec)
    if name == "router":
        return (None,) * dims

    # ---- FFN / generic 2-D (+stack) mats: [*, d_in, d_out] ----
    if dims - off == 2:
        in_idx, out_idx = off, off + 1
        if name in ("wo", "out_proj"):
            # contracts ff/width (TP'd): FSDP on d_out
            spec = [None] * dims
            spec[in_idx] = TP if tp_ok(shape[in_idx]) else None
            if _div(shape[out_idx], sizes, dp):
                spec[out_idx] = dp
            return tuple(spec)
        if name == "conv_w":
            return (None,) * (dims - 1) + (TP if tp_ok(shape[-1]) else None,)
        # wi/wg/wx/wy/in_proj/...: contracts d_in -> TP(+FSDP) on d_out
        spec = [None] * dims
        spec[out_idx] = out_sharding(shape[out_idx], want_tp=True)
        return tuple(spec)
    if name in ("gate_a", "gate_x"):
        # [*, nb, bd, bd] — gate heads over TP
        return ((None,) * off + (TP if tp_ok(shape[off]) else None,)
                + (None,) * (dims - off - 1))
    return (None,) * dims


def param_pspecs(params_shape: Any, mesh: Any) -> Any:
    """Spec tree matching a params tree (tensors, ``meta`` ones included)."""
    sizes = mesh_shape(mesh)
    return _map_with_path(
        lambda path, leaf: _leaf_spec("/".join(path), tuple(leaf.shape), sizes),
        params_shape)


def strip_dp(specs: Any) -> Any:
    """Serving params: drop the FSDP (dp) axes, keep pure TP.

    FSDP weight sharding is a TRAINING memory optimization; at serve time it
    makes every matmul either all-gather its weights or psum partial products
    on the dp axis.  Weights replicate over dp and shard over "model" only.
    """

    def fix(spec: tuple) -> tuple:
        out = []
        for entry in spec:
            if entry is None or entry == TP:
                out.append(entry)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a == TP)
                out.append(kept[0] if len(kept) == 1 else (kept or None))
            else:                      # a dp axis name
                out.append(None)
        return tuple(out)

    return _map_specs(fix, specs)


# --------------------------------------------------------------------------- #
# step inputs / caches
# --------------------------------------------------------------------------- #
def input_pspecs(specs: dict, mesh: Any, *, family: str) -> dict:
    sizes = mesh_shape(mesh)

    def leaf(name, t):
        if name in ("tokens", "labels", "prefix_embeds"):
            return (batch_axes(t.shape[0], sizes),) + (None,) * (t.ndim - 1)
        if name == "pos":
            return ()
        return (None,) * t.ndim

    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(v, sizes, family=family)
        else:
            out[k] = _map_with_path(lambda _, t, k=k: leaf(k, t), v)
    return out


def cache_pspecs(cache_specs: Any, mesh: Any, *, family: str) -> Any:
    """Decode-cache specs; the leading axis is always the layer stack."""
    sizes = mesh_shape(mesh)

    def leaf(path, t):
        name = next((p for p in reversed(path) if not p.isdigit()), "")
        shp = t.shape
        dp = batch_axes(shp[1], sizes) if t.ndim >= 2 else None
        if family == "transformer":
            if name in ("k", "v"):
                # [L, B, S, KV, hd]: kv-heads over TP when divisible, else
                # sequence-sharded (distributed flash-decoding layout)
                if _div(shp[3], sizes):
                    return (None, dp, None, TP, None)
                return (None, dp, TP, None, None)
            if name in ("ckv", "kr"):
                return (None, dp, TP, None)      # MLA latent: shard sequence
        if family == "mamba2":
            if name == "ssm":
                return (None, dp, TP if _div(shp[2], sizes) else None, None, None)
            if name == "conv":
                return (None, dp, None, TP if _div(shp[3], sizes) else None)
        if family == "griffin":
            if name in ("k", "v"):
                return (None, dp, TP if _div(shp[2], sizes) else None, None, None)
            if name == "slot_pos":
                return (None, TP if _div(shp[1], sizes) else None)
            if name == "lru":
                return (None, dp, TP if _div(shp[2], sizes) else None)
            if name == "conv":
                return (None, dp, None, TP if _div(shp[3], sizes) else None)
        return (None,) * t.ndim

    return _map_with_path(leaf, cache_specs)


# --------------------------------------------------------------------------- #
# shards and DTensor placements
# --------------------------------------------------------------------------- #
def shard_shape(shape: tuple[int, ...], spec: tuple, mesh: Any) -> tuple[int, ...]:
    """The local shard's shape of a tensor of ``shape`` under ``spec``
    (``NamedSharding.shard_shape``: every sharded dim must divide)."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        k = math.prod(sizes[a] for a in _axes(spec[d] if d < len(spec) else None))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide into "
                             f"{k} shards ({spec})")
        out.append(n // k)
    return tuple(out)


def local_slices(shape: tuple[int, ...], spec: tuple, mesh: Any,
                 coord: Mapping[str, int]) -> tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the rank at mesh coordinates
    ``coord`` ({axis: index}) holds under ``spec``, in DTensor's order: a
    dim's axes split it in mesh-dim order, the first mesh dim major."""
    sizes = mesh_shape(mesh)
    local = shard_shape(shape, spec, sizes)
    out = []
    for d, n in enumerate(local):
        entry = spec[d] if d < len(spec) else None
        block = 0
        for a in (a for a in sizes if a in _axes(entry)):
            block = block * sizes[a] + int(coord[a])
        out.append(slice(block * n, (block + 1) * n))
    return tuple(out)


def spec_at(specs: Any, path: str) -> tuple:
    """The spec at ``path`` ("blocks/attn/wq", list indices as digits) of a
    spec tree."""
    for key in path.split("/"):
        specs = specs[int(key)] if isinstance(specs, list) else specs[key]
    return specs


def block_keeper(specs: Any, mesh: Any, coord: Mapping[str, int]):
    """``keep(path, tensor, stacked)`` for a param init (the transformer's
    ``init_params``): the block of a whole tensor that the rank at mesh
    coordinates ``coord`` holds under the spec at ``path`` of ``specs``
    (for one layer of a stacked leaf, the spec without its layer entry),
    as a copy of its own so that the whole can be freed; a tensor the rank
    holds whole comes back as it is."""
    sizes = mesh_shape(mesh)

    def keep(path: str, t, stacked: bool = False):
        spec = spec_at(specs, path)
        sl = local_slices(tuple(t.shape), spec[1:] if stacked else spec,
                          sizes, coord)
        if all(x.start == 0 and x.stop == n for x, n in zip(sl, t.shape)):
            return t
        return t[sl].clone()

    return keep


def placements(spec: tuple, mesh: Any) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on a ``DeviceMesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            i = names.index(a)
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh axis {a!r} shards two dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def tree_placements(specs: Any, mesh: Any) -> Any:
    """:func:`placements` over a spec tree."""
    return _map_specs(lambda s: placements(s, mesh), specs)


# --------------------------------------------------------------------------- #
# attention heads of a tensor-parallel rank
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class LocalHeads:
    """The attention heads one rank of a "model" axis runs: query heads
    ``[q0, q0 + h)`` and the contiguous kv heads ``[kv0, kv0 + kv)`` they
    read, h / kv query heads a kv head.  ``q_sharded`` /
    ``kv_sharded``: whether the policy shards wq / wk (and the kv cache's
    heads) over "model", else the rank holds them whole."""

    h: int
    kv: int
    q0: int
    kv0: int
    q_sharded: bool
    kv_sharded: bool


def local_heads(n_heads: int, n_kv: int, tp: int, rank: int) -> LocalHeads:
    """The heads the rank at ``rank`` on a "model" axis of ``tp`` runs.

    Heads shard where H divides the axis (the policy's rule for wq and wo),
    H_loc = H / tp a rank; with G = H / KV the rank's query heads read
    H_loc / G kv heads (G divides H_loc) or one (H_loc divides G): its
    local G is min(G, H_loc).  Where neither divides the other a rank's
    heads would straddle kv heads unevenly, and this raises.  Where H does
    not divide the axis every rank runs every head.
    """
    g = n_heads // n_kv
    kv_sharded = n_kv % tp == 0
    if n_heads % tp:
        return LocalHeads(n_heads, n_kv, 0, 0, False, kv_sharded)
    h = n_heads // tp
    if h % g and g % h:
        raise ValueError(f"{n_heads} query heads over {tp} ranks ({h} a rank) "
                         f"do not nest with groups of {g} per kv head")
    q0 = rank * h
    return LocalHeads(h, max(1, h // g), q0, q0 // g, True, kv_sharded)
