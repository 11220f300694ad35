"""Composable decoder-only transformer: every transformer of the reference.

One config dataclass + plain functions on tensors, in the reference's
layouts: ``wq`` [d,H,hd], ``wk``/``wv`` [d,KV,hd], ``wo`` [H,hd,d], FFN
``wi``/``wg`` [d,ff] and ``wo`` [ff,d], blocks stacked on a leading L axis.
Layers run as a Python loop over that axis.  Feature axes, as in the
reference: GQA/MQA/MHA via ``n_kv``; MLA (DeepSeek-V2: latent KV, decoupled
RoPE key); token-choice top-k MoE with capacity, shared experts and leading
dense layers; per-layer sliding windows; attention and final soft-caps and
sandwich norms (Gemma-2); the parallel block (Command-R); QK-norm (Qwen3);
partial RoPE (StableLM-2); a projected modality prefix (InternVL2).
Attention is the K1 flash kernel (``models/attention.py``), MLA's with a
qk head dim wider than its v head dim; the projections, the experts, the
FFN and the LM head are plain (batched) matrix products.

Tensor parallelism (dense GQA configs, in a region of
``distributed/context.py``): the functions run on this rank's blocks of the
weights, as ``param_pspecs`` shards them, and take their local head and ff
counts from the weights' shapes.  ``hidden`` activations [B,S,d] are
sequence-parallel between the attention and FFN regions: each block
all-gathers its normed input over S before the q/k/v and FFN products
(``gather_seq``), and :func:`constrain` reduce-scatters the products with
``wo`` back (or all-reduces them where ``hidden`` is replicated).  K1 runs
on the rank's query heads and the kv heads they read (``local_heads``);
the embedding is a vocab-parallel lookup and the logits come out sharded
over the vocabulary where it divides the "model" axis.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.context import (
    all_gather_model,
    batch_group,
    constrain,
    current_region,
    gather_seq,
    seq_sharded,
    to_hidden,
)
from ..distributed.sharding import LocalHeads, local_heads
from .attention import chunked_attention
from .common import (
    Params,
    activation,
    apply_norm,
    apply_rope,
    dense_init,
    embed_init,
    layer,
    norm_params,
    softcap,
    stack_layers,
    unstack_layers,
)

# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN hidden size
    num_shared: int = 0             # always-on shared experts (DeepSeek)
    first_dense_layers: int = 0     # leading dense layers (DeepSeek-V2)
    dense_d_ff: int = 0             # FFN width of those dense layers
    capacity_factor: float = 1.25
    router_scale: bool = True       # normalize top-k gate weights to sum 1


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    act: str = "silu"
    norm: str = "rms"                  # rms | rms1 | ln
    glu: bool = True                   # gated FFN (SwiGLU/GeGLU) vs plain MLP
    parallel_block: bool = False
    qk_norm: bool = False
    post_norm: bool = False            # gemma2 sandwich norms
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_frac: float = 1.0             # partial rotary (stablelm-2: 0.25)
    attn_scale: float | None = None    # override 1/sqrt(head_dim)
    # per-layer window schedule, cycled: 0 = global, w>0 = sliding window
    window_pattern: tuple[int, ...] = (0,)
    tie_embeddings: bool = False
    embed_inputs: bool = False         # inputs are embeddings, not token ids
    embed_scale: bool = False          # multiply embeddings by sqrt(d) (gemma)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # vlm: number of prepended modality tokens in input_specs (0 = none)
    prefix_tokens: int = 0
    prefix_dim: int = 0                # raw dim of modality embeddings

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def windows(self) -> np.ndarray:
        pat = self.window_pattern or (0,)
        return np.array([pat[i % len(pat)] for i in range(self.n_layers)],
                        dtype=np.int32)

    @property
    def params_per_block(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk = m.nope_head_dim + m.rope_head_dim
            attn = (d * self.n_heads * qk                 # W_q
                    + d * (m.kv_lora + m.rope_head_dim)   # W_dkv + W_kr
                    + m.kv_lora * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)    # W_o
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
        if self.moe is not None:
            f = (3 if self.glu else 2) * d * self.moe.d_expert
            ffn = self.moe.num_experts * f + self.moe.num_shared * f \
                + d * self.moe.num_experts  # router
        else:
            ffn = (3 if self.glu else 2) * d * self.d_ff
        return attn + ffn

    @property
    def active_params_per_block(self) -> int:
        if self.moe is None:
            return self.params_per_block
        d = self.d_model
        f = (3 if self.glu else 2) * d * self.moe.d_expert
        total = self.params_per_block
        return total - self.moe.num_experts * f + self.moe.top_k * f

    def num_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * self.params_per_block

    def num_active_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * self.active_params_per_block


def n_lead(cfg: TransformerConfig) -> int:
    """Leading dense layers (DeepSeek-V2) before the stacked blocks."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


@functools.lru_cache(maxsize=None)
def lead_config(cfg: TransformerConfig) -> TransformerConfig:
    """The config of the leading dense layers: no MoE, FFN ``dense_d_ff``."""
    return dataclasses.replace(cfg, moe=None, d_ff=cfg.moe.dense_d_ff or cfg.d_ff)


def layer_at(params: Params, cfg: TransformerConfig, i: int):
    """Global layer ``i``: ``(params, config, window, cache group, index in
    the group)``; the lead blocks come first, with window 0."""
    nl = n_lead(cfg)
    if i < nl:
        return params["lead_blocks"][i], lead_config(cfg), 0, "lead", i
    return (layer(params["blocks"], i - nl), cfg, int(cfg.windows()[i]),
            "blocks", i - nl)


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def _block_params(cfg: TransformerConfig, gen: torch.Generator, device,
                  dtype) -> Params:
    """One block, with the reference's keys, shapes and order of draws."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv

    def dense(shape, dt=dtype):
        return dense_init(gen, shape, device, dt)

    def norm(width):
        return norm_params(width, cfg.norm, device, dtype)

    p: dict[str, Any] = {"ln1": norm(d)}
    if not cfg.parallel_block:
        p["ln2"] = norm(d)
    if cfg.post_norm:
        p["ln1_post"] = norm(d)
        p["ln2_post"] = norm(d)
    if cfg.mla is not None:
        m = cfg.mla
        p["attn"] = {
            "wq": dense((d, h, m.nope_head_dim + m.rope_head_dim)),
            "wdkv": dense((d, m.kv_lora)),
            "wkr": dense((d, m.rope_head_dim)),
            "kv_ln": norm_params(m.kv_lora, "rms", device, dtype),
            "wuk": dense((m.kv_lora, h, m.nope_head_dim)),
            "wuv": dense((m.kv_lora, h, m.v_head_dim)),
            "wo": dense((h, m.v_head_dim, d)),
        }
    else:
        p["attn"] = {"wq": dense((d, h, hd)), "wk": dense((d, kv, hd)),
                     "wv": dense((d, kv, hd)), "wo": dense((h, hd, d))}
    if cfg.qk_norm:
        p["attn"]["q_norm"] = norm_params(hd, "rms", device, dtype)
        p["attn"]["k_norm"] = norm_params(hd, "rms", device, dtype)

    def ffn(width: int, prefix=()) -> Params:
        q = {"wi": dense((*prefix, d, width)), "wo": dense((*prefix, width, d))}
        if cfg.glu:
            q["wg"] = dense((*prefix, d, width))
        return q

    if cfg.moe is not None:
        moe = cfg.moe
        # the router stays float32 whatever the param dtype, as in the reference
        p["moe"] = {"router": dense((d, moe.num_experts), torch.float32),
                    "experts": ffn(moe.d_expert, (moe.num_experts,))}
        if moe.num_shared:
            p["moe"]["shared"] = ffn(moe.d_expert * moe.num_shared)
    else:
        p["mlp"] = ffn(cfg.d_ff)
    return p


def _whole(path: str, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    return t


def _kept(keep, path: str, tree: Any, stacked: bool = False) -> Any:
    """``keep(path/key, leaf, stacked)`` over a dict tree of tensors."""
    if isinstance(tree, dict):
        return {k: _kept(keep, f"{path}/{k}", v, stacked) for k, v in tree.items()}
    return keep(path, tree, stacked)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype=torch.float32, keep=None) -> Params:
    """Random weights made directly on ``device`` from ``generator``.

    The distributions are the reference's (``dense_init``: normal with std
    1/sqrt(shape[-2]) per block tensor; ``embed_init``: std 0.02); the
    numbers differ, since the generators do.  Stacked layers are drawn one
    at a time into the stacked tensors (``stack_layers``); the lead blocks
    (DeepSeek-V2's dense first layers) are a list, ``prefix_proj`` projects
    modality embeddings (InternVL2).  The embedding, the final norm and the
    head come first, then the layers in order, so the first n layers of a
    deeper config draw the same numbers.

    ``keep(path, tensor, stacked)`` (``sharding.block_keeper``) is called on
    every tensor as it is drawn, whole, with its path in the tree
    ("blocks/attn/wq"; ``stacked``: one layer of a stacked leaf), and what
    it returns is kept: a rank of a mesh keeps its block and frees the
    rest, so a model that no card holds whole is drawn block by block, each
    block bit for bit the one of the whole draw.
    """
    dev = resolve_device(device)
    keep = keep or _whole
    params: dict[str, Any] = {
        "embed": keep("embed", embed_init(generator, (cfg.vocab, cfg.d_model),
                                          dev, dtype)),
        "final_norm": _kept(keep, "final_norm",
                            norm_params(cfg.d_model, cfg.norm, dev, dtype)),
    }
    if not cfg.tie_embeddings:
        params["head"] = keep("head", dense_init(
            generator, (cfg.d_model, cfg.vocab), dev, dtype))
    nl = n_lead(cfg)
    if nl:
        params["lead_blocks"] = [
            _kept(keep, f"lead_blocks/{i}",
                  _block_params(lead_config(cfg), generator, dev, dtype))
            for i in range(nl)]
    params["blocks"] = stack_layers(
        cfg.n_layers - nl,
        lambda: _kept(keep, "blocks", _block_params(cfg, generator, dev, dtype),
                      stacked=True))
    if cfg.prefix_tokens:
        params["prefix_proj"] = keep("prefix_proj", dense_init(
            generator, (cfg.prefix_dim or cfg.d_model, cfg.d_model), dev, dtype))
    return params


# --------------------------------------------------------------------------- #
# tensor-parallel layout
# --------------------------------------------------------------------------- #
def heads_of(cfg: TransformerConfig) -> LocalHeads:
    """The attention heads this rank runs: ``local_heads`` in a
    tensor-parallel region, else all of them."""
    r = current_region()
    if r is None:
        return LocalHeads(cfg.n_heads, cfg.n_kv, 0, 0, False, False)
    return local_heads(cfg.n_heads, cfg.n_kv, r.tp, r.rank)


# --------------------------------------------------------------------------- #
# FFN: dense and MoE
# --------------------------------------------------------------------------- #
def dense_ffn(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    """The (gated) MLP of x [B,S,d] (whole S) -> [B,S,d] in ``hidden``'s
    layout, its inner products constrained as ``ff``, its output as
    ``hidden`` (a partial sum where the rank holds a block of ff)."""
    hg = constrain(x @ p["wi"].to(x.dtype), "ff", width=cfg.d_ff)
    if cfg.glu:
        h = activation(hg, cfg.act) * constrain(x @ p["wg"].to(x.dtype), "ff",
                                                width=cfg.d_ff)
    else:
        h = activation(hg, cfg.act)
    return constrain(h @ p["wo"].to(h.dtype), "hidden",
                     partial=p["wo"].shape[0] != cfg.d_ff)


@dataclass(frozen=True)
class MoERouting:
    """Token-choice top-k routing of ``t`` tokens with capacity ``cap``.

    ``experts``/``weights`` [t, k]: each token's experts, best first, and
    their gate weights; ``slot`` [t, k]: the token's rank inside that
    expert's group (>= ``cap``: dropped); ``idx``/``wmat`` [E, cap]: the
    token and weight in each expert slot (token 0 and weight 0 where empty).
    """

    experts: torch.Tensor
    weights: torch.Tensor
    slot: torch.Tensor
    idx: torch.Tensor
    wmat: torch.Tensor
    cap: int


def moe_capacity(t: int, moe: MoEConfig) -> int:
    return max(int(np.ceil(t * moe.top_k / moe.num_experts * moe.capacity_factor)), 4)


def moe_route(xf: torch.Tensor, router: torch.Tensor,
              moe: MoEConfig) -> MoERouting:
    """The reference's routing (``moe_ffn``), with the same discrete output.

    Softmax gates in float32; top-k with ties to the lower expert id, as
    ``jax.lax.top_k`` (a stable descending sort); optional renormalisation;
    slots from a stable sort by expert.  Every shape follows from t, k and
    E, and nothing here waits on the device (no ``bincount``, no boolean
    indexing).

    Where ``xf`` is this rank's rows of a batch that a group of ranks
    splits (``distributed.context.split_batch``), the capacity is the whole
    batch's and a choice's place in its expert's group counts the choices
    of the ranks ahead of this one first (one all-gather of the per-expert
    counts), as the one-device routing of the whole batch orders them;
    ``slot`` is then the choice's column in this rank's [E, cap] buffer,
    ``cap`` where the whole batch's routing drops it.
    """
    t, k, e = xf.shape[0], moe.top_k, moe.num_experts
    gates = torch.softmax(xf.float() @ router.float(), dim=-1)      # [t, E]
    topv, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, tope = topv[:, :k], tope[:, :k]
    if moe.router_scale:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = tope.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # rank inside the expert's group: position minus the group's first one
    first = torch.searchsorted(e_sorted, e_sorted)
    slot_sorted = torch.arange(t * k, device=xf.device) - first
    group = batch_group()
    if group is None:
        cap = moe_capacity(t, moe)
    else:
        n = dist.get_world_size(group)
        counts = torch.zeros(e, dtype=torch.long, device=xf.device).index_add_(
            0, e_flat, torch.ones_like(e_flat))
        every = counts.new_empty(n * e)
        dist.all_gather_into_tensor(every, counts, group=group)
        ahead = every.view(n, e)[:dist.get_rank(group)].sum(0)
        cap = moe_capacity(t * n, moe)
        slot_sorted = torch.where(slot_sorted + ahead[e_sorted] < cap,
                                  slot_sorted, cap)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    # overflow lands in a dump column (cap), sliced off
    col = slot_sorted.clamp_max(cap)
    tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    idx = torch.zeros((e, cap + 1), dtype=torch.long, device=xf.device)
    idx[e_sorted, col] = tok[order]
    wmat = torch.zeros((e, cap + 1), dtype=torch.float32, device=xf.device)
    wmat[e_sorted, col] = topv.reshape(-1)[order]
    return MoERouting(tope, topv, slot.view(t, k), idx[:, :cap],
                      wmat[:, :cap], cap)


def moe_ffn(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    """Token-choice top-k MoE with capacity, gather-based dispatch.

    x [B,S,d] -> [B,S,d].  The experts run as batched products over
    [E, cap, d] (the reference leaves them to XLA).  Each token then gathers
    its k weighted expert outputs and sums them in k order, so the result is
    deterministic (no float scatter-add); a dropped choice adds nothing.
    """
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    r = moe_route(xf, p["router"], moe)
    xin = xf[r.idx]                                               # [E, C, d]
    we = p["experts"]
    hg = torch.bmm(xin, we["wi"].to(xin.dtype))
    if cfg.glu:
        h = activation(hg, cfg.act) * torch.bmm(xin, we["wg"].to(xin.dtype))
    else:
        h = activation(hg, cfg.act)
    eout = torch.bmm(h, we["wo"].to(h.dtype))                    # [E, C, d]
    eout = eout * r.wmat[..., None].to(eout.dtype)
    kept = r.slot < r.cap                                         # [t, k]
    rows = r.experts * r.cap + r.slot.clamp_max(r.cap - 1)
    picked = eout.reshape(-1, d)[rows.reshape(-1)].view(t, moe.top_k, d)
    out = torch.where(kept[..., None], picked, 0).sum(dim=1)
    if moe.num_shared:
        out = out + dense_ffn(xf, p["shared"], cfg)
    return out.reshape(b, s, d).to(x.dtype)


def ffn_forward(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    """The block's FFN: MoE where the config has one, else dense."""
    return moe_ffn(x, p["moe"], cfg) if cfg.moe is not None \
        else dense_ffn(x, p["mlp"], cfg)


# --------------------------------------------------------------------------- #
# attention projections (dense GQA and MLA)
# --------------------------------------------------------------------------- #
def project_qkv(x: torch.Tensor, p: Params, cfg: TransformerConfig,
                pos: torch.Tensor):
    """q [B,S,H,hd], k/v [B,S,KV,hd] of x [B,S,d] at positions ``pos`` [S]:
    projections, optional qk-norm, RoPE on q and k.  H and KV are the
    weights' (a rank's blocks in a tensor-parallel region)."""
    b, s, d = x.shape
    h, kv, hd = p["wq"].shape[-2], p["wk"].shape[-2], cfg.hd
    q = (x @ p["wq"].to(x.dtype).reshape(d, h * hd)).view(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(d, kv * hd)).view(b, s, kv, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(d, kv * hd)).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = apply_norm(q, p["q_norm"], "rms")
        k = apply_norm(k, p["k_norm"], "rms")
    rd = int(cfg.hd * cfg.rope_frac) if cfg.rope_frac < 1.0 else None
    q = apply_rope(q, pos, cfg.rope_theta, rope_dim=rd)
    k = apply_rope(k, pos, cfg.rope_theta, rope_dim=rd)
    return q, k, v


def project_mla(x: torch.Tensor, p: Params, cfg: TransformerConfig,
                pos: torch.Tensor):
    """MLA projections of x [B,S,d] at ``pos`` [S]: q_nope [B,S,H,nope],
    q_rope [B,S,H,rope] (rotated), the normalised latent ckv [B,S,kv_lora]
    and the shared rotated key kr [B,S,rope]; ckv and kr are what the cache
    holds."""
    m = cfg.mla
    b, s, d = x.shape
    h, qk = cfg.n_heads, m.nope_head_dim + m.rope_head_dim
    q = (x @ p["wq"].to(x.dtype).reshape(d, h * qk)).view(b, s, h, qk)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    ckv = apply_norm(x @ p["wdkv"].to(x.dtype), p["kv_ln"], "rms")
    kr = x @ p["wkr"].to(x.dtype)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    kr = apply_rope(kr[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, kr


def attn_forward(x: torch.Tensor, p: Params, cfg: TransformerConfig, *,
                 window: int):
    """Full-sequence attention (prefill compute). x: [B,S,d].

    Returns ``(out [B,S,d], cache entries)``: the post-RoPE ``{"k", "v"}``
    it attended over, or MLA's latent ``{"ckv", "kr"}``, what prefill
    writes into the cache.  MLA attends with k = [k_nope, shared rope key]
    of width nope + rope and v of width v_head_dim (K1 at qk hd != v hd),
    scaled by (nope + rope)^-0.5.
    """
    b, s, d = x.shape
    h = cfg.n_heads
    pos = torch.arange(s, device=x.device)
    if cfg.mla is not None:
        m = cfg.mla
        q_nope, q_rope, ckv, kr = project_mla(x, p, cfg, pos)
        lat = ckv.reshape(b * s, m.kv_lora)
        k_nope = (lat @ p["wuk"].to(x.dtype).reshape(m.kv_lora, -1)).view(
            b, s, h, m.nope_head_dim)
        v = (lat @ p["wuv"].to(x.dtype).reshape(m.kv_lora, -1)).view(
            b, s, h, m.v_head_dim)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, h, m.rope_head_dim)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = chunked_attention(q, k, v, causal=True, window=window,
                              logit_cap=cfg.attn_softcap,
                              scale=(m.nope_head_dim + m.rope_head_dim) ** -0.5)
        out = o.reshape(b, s, h * m.v_head_dim) @ \
            p["wo"].to(o.dtype).reshape(h * m.v_head_dim, d)
        return out, {"ckv": ckv, "kr": kr}
    hd = cfg.hd
    q, k, v = project_qkv(x, p, cfg, pos)
    q = constrain(q, "heads", width=cfg.n_heads)
    k = constrain(k, "heads", width=cfg.n_kv)
    v = constrain(v, "heads", width=cfg.n_kv)
    lh = heads_of(cfg)
    kq, vq = _kv_of_queries(k, v, lh)
    o = chunked_attention(q, kq, vq, causal=True, window=window,
                          logit_cap=cfg.attn_softcap, scale=cfg.attn_scale)
    out = o.reshape(b, s, lh.h * hd) @ p["wo"].to(o.dtype).reshape(lh.h * hd, d)
    return constrain(out, "hidden", partial=lh.q_sharded), {"k": k, "v": v}


def _kv_of_queries(k: torch.Tensor, v: torch.Tensor, lh: LocalHeads):
    """The kv heads [B,S,kv,hd] a rank's query heads read: k/v as they are
    where the rank holds just those (kv heads sharded, or all heads run),
    else the slice ``[kv0, kv0 + kv)`` of the whole kv heads."""
    if lh.kv_sharded or not lh.q_sharded:
        return k, v
    sl = slice(lh.kv0, lh.kv0 + lh.kv)
    return k[:, :, sl], v[:, :, sl]


# --------------------------------------------------------------------------- #
# block + full model forward (prefill)
# --------------------------------------------------------------------------- #
def block_forward(x: torch.Tensor, p: Params, cfg: TransformerConfig, *,
                  window: int, return_kv: bool = False, seq: int | None = None):
    """One block: pre-norm attention and FFN, with Gemma-2's post-norms on
    both outputs, or Command-R's parallel block (x + attn(h) + ffn(h)).
    With ``return_kv``: ``(x, cache entries)`` as attn_forward's.

    x is in ``hidden``'s layout; ``seq`` is the global sequence length
    (default x's), which says whether that layout shards S.  Each normed
    input is gathered whole over S for the products."""
    s = x.shape[1] if seq is None else seq
    h = gather_seq(apply_norm(x, p["ln1"], cfg.norm), s)
    attn, kv = attn_forward(h, p["attn"], cfg, window=window)
    if cfg.post_norm:
        attn = apply_norm(attn, p["ln1_post"], cfg.norm)
    if cfg.parallel_block:
        x = x + attn + ffn_forward(h, p, cfg)
    else:
        x = x + attn
        f = ffn_forward(gather_seq(apply_norm(x, p["ln2"], cfg.norm), s), p, cfg)
        if cfg.post_norm:
            f = apply_norm(f, p["ln2_post"], cfg.norm)
        x = x + f
    return (x, kv) if return_kv else x


def embed_tokens(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids [B,S] -> activations [B,S,d] in ``compute_dtype``.

    Activations are ``compute_dtype`` (bf16) whatever the parameter dtype;
    the boundary byte counts depend on that.  The lookup is
    ``F.embedding``, whose gradient sums each row's tokens in a fixed order
    (an indexing gradient accumulates in parallel on the CPU, in no fixed
    order).

    In a tensor-parallel region the result is in ``hidden``'s layout.  Where
    the embedding's rows are sharded over "model" (the vocabulary divides
    it) each rank looks up the tokens in its rows, zeros the others and the
    lookup ends in the ``hidden`` reduce (a sum with one nonzero term:
    exact); else the lookup is whole on every rank.
    """
    emb = params["embed"]
    if emb.shape[0] == cfg.vocab:
        x = F.embedding(tokens, emb).to(compute_dtype)
        partial = False
    else:                                   # this rank's rows of the vocab
        n = emb.shape[0]
        local = tokens - current_region().rank * n
        inside = (local >= 0) & (local < n)
        x = (F.embedding(local.clamp(0, n - 1), emb).to(compute_dtype)
             * inside[..., None].to(compute_dtype))
        partial = True
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype)
    return to_hidden(x, partial)


def embed_prefix(params: Params, prefix_embeds: torch.Tensor,
                 x: torch.Tensor, seq: int | None = None) -> torch.Tensor:
    """Modality embeddings [B,P,prefix_dim], projected to d and put before
    the text activations x [B,S,d] (InternVL2's patch embeddings).

    In a tensor-parallel region x is in ``hidden``'s layout (``seq``: its
    global S, default x's) and so is the result; ``prefix_proj``'s output
    columns may be sharded over "model", and are gathered."""
    pe = prefix_embeds.to(x.dtype) @ params["prefix_proj"].to(x.dtype)
    if current_region() is None:
        return torch.cat([pe, x], dim=1)
    if pe.shape[-1] != x.shape[-1]:        # d's columns sharded: gather them
        pe = torch.cat(all_gather_model(pe).unbind(0), dim=-1)
    x = gather_seq(x, x.shape[1] if seq is None else seq)
    return to_hidden(torch.cat([pe, x], dim=1), partial=False)


def forward_hidden(params: Params, cfg: TransformerConfig, x: torch.Tensor,
                   seq: int | None = None) -> torch.Tensor:
    """Run all blocks on embedded inputs x: [B,S,d] -> [B,S,d] (pre-head):
    the lead blocks first, then the stacked ones.

    x is in ``hidden``'s layout, as :func:`embed_tokens` and
    :func:`embed_prefix` return it, and so is the result; ``seq`` is the
    global sequence length (default x's), which a tensor-parallel region
    needs where S is sharded.

    Under grad mode each stacked block is checkpointed
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed in the backward, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over its scanned blocks; the lead
    blocks are not, as in the reference.  The stacked leaves are unbound
    once (``unstack_layers``).
    """
    s = x.shape[1] if seq is None else seq
    x = constrain(x, "hidden", width=s)
    nl = n_lead(cfg)
    for i in range(nl):
        x = block_forward(x, params["lead_blocks"][i], lead_config(cfg),
                          window=0, seq=s)
    remat = torch.is_grad_enabled()
    windows = cfg.windows()
    for j, lp in enumerate(unstack_layers(params["blocks"])):
        w = int(windows[nl + j])
        if remat:
            x = checkpoint(block_forward, x, lp, cfg, window=w, seq=s,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block_forward(x, lp, cfg, window=w, seq=s)
    return apply_norm(x, params["final_norm"], cfg.norm)


def last_position(x: torch.Tensor, seq: int) -> torch.Tensor:
    """x[:, -1:] of ``hidden`` x of global length ``seq``: where S is
    sharded the last position lives on the last rank, whose row every rank
    gathers."""
    if not seq_sharded(seq):
        return x[:, -1:]
    return all_gather_model(x[:, -1:])[-1]


def logits_fn(params: Params, cfg: TransformerConfig,
              h: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] in float32 with the final soft-cap; in a
    tensor-parallel region the rank's block of the vocabulary where the
    head's (or the tied embedding's) vocab is sharded."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = h @ w.to(h.dtype)
    return softcap(logits.float(), cfg.final_softcap)
