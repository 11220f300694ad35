"""K4, the Mamba-2 SSD chunk scan: the Hopper kernels' wrapper and their plain versions.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py::ssd_chunk``
(``_ssd_kernel``) together with the model-layout wrapper ``ops.ssd``: per
chunk of Q steps, ``cums = cumsum(dt·A)``, ``L = tril(exp(cums_i −
cums_j))``, ``y = ((C Bᵀ)∘L)(dt·x) + (C∘e^{cums}) S`` and the float32
state ``S ← S·e^{cums[-1]} + (B∘e^{cums[-1]−cums})ᵀ(dt·x)`` carried across
chunks.  Beyond the TPU kernel it seeds S from ``state_in`` and returns the
final S, as the model path (``models/mamba2.py::ssd_chunked``) needs for
chunked prefill and decode.  B and C are per group; head h reads group
h // (H / G), in the kernel, with no repeat.

What bounds it on the H100: at the Mamba-2 prefill shape (B=1, S=512,
H=64, P=64, G=1, N=128, chunk 256, bf16, final state returned) it moves
10.9 MB (3.2 us at 3.35 TB/s) against 1.63 GFLOP of products that this
input needs (the lower triangles, C Bᵀ once per group).  The bf16 instance
(``csrc/ssd_chunk.cu``) runs the chunks in parallel with every product on
the tensor cores, in two launches: the chunk-state kernel (cums, each
chunk's own state Ŝ with B∘w split into two bf16 halves so the state keeps
~2⁻¹⁶ relative error, then the sequential carry over chunks in float32, by
the last block of each head to finish) and the chunk-scan kernel (y per
64-row tile: C Bᵀ and the masked scores times x as K1's Q Kᵀ and P V, plus
C S_in with S_in as two halves).  Each stage has its plain version here:
:func:`ssd_chunk_state_plain`, :func:`ssd_state_pass_plain` (the carry) and
:func:`ssd_chunk_scan_plain`; :func:`ssd_stages` exposes the kernels'
stages on the card so that tests can hold each against them.  The float32
instance (training's, at B=2, S=512 with no state_in and no final state:
2.19 GFLOP of float32-accurate products, 13.2 us as 3xTF32 at 495 TFLOP/s)
runs every product on the tensor cores as ``mma.sync`` TF32 in a 3xTF32
split (``csrc/tf32x3.cuh``: float32 accuracy; one TF32 product misses
the 1e-4 tolerance), in three launches: C Bᵀ once per (batch, group,
chunk) into scratch; the chunk-parallel state pass (cums, each chunk's own Ŝ, the carry by the last
block to finish, as the bf16 instance, writing S_in over Ŝ; the last
chunk's Ŝ only when the final state is returned); and y per (batch·head,
chunk, 64-row tile), the tiles with the most pairs first.

Training differentiates it: for CUDA tensors that need a gradient the
wrapper runs the float32 instance (bf16 x, B and C cast to float32 first, as
the reference's ``ssd_chunked`` scans in float32, y cast back) through an
autograd function that saves its inputs (never y) and whose backward is a
kernel of its own (``csrc/ssd_chunk_bwd.cu``), which replaces no TPU kernel
(the reference differentiates ``models/mamba2.py::ssd_chunked``): the VJP of
:func:`ssd_plain`, written out in :func:`ssd_bwd_plain`.  What bounds it:
at Mamba-2's training shape (B=2, S=512, H=64, P=64, G=1, N=128, chunk 256)
the function needs 9.19 GFLOP of float32-accurate products (the lower
triangles of C Bᵀ, dy xbarᵀ, Wᵀ dy, Zᵀ C and Z B; the chunks' own states
forward and back where a carry reads them; the state terms where S_in or
dS_out is not 0), 56 us as 3xTF32 on the tensor cores, against 53 MB
moved (16 us).  Every product runs there as the forward's, in seven
launches: C Bᵀ once per (batch, group, chunk) (the forward's
kernel); the state pass forward (S_in per chunk, recomputed: the forward
saves nothing) and reversed (each chunk's own dŜ = (C∘e^{cums})ᵀ dy, then
dS_out per chunk from the final state's cotangent down to d state_in);
a column pass and a row pass, one block
per (batch·head, chunk, 64-row tile) with its accumulators in registers,
each recomputing the tiles of dy xbarᵀ it needs and reading C Bᵀ from
scratch; a finishing pass per (batch·head, chunk) (the reverse cumsum of
dcums, ddt, each chunk's part of dA); and the sums over each group's heads
(dB, dC) and over (batch, chunk) (dA) in a fixed order.  No float atomics:
two calls give the same bits.

The carry's tickets count on one zeroed counter buffer per card that the
kernel leaves at 0 (``build.counters``), so calls on one card must be
ordered on one stream (as the model path is), and a CUDA graph captures a
call without a memset.  The wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build, cost

__all__ = ["ssd", "ssd_plain", "ssd_chunk_state_plain", "ssd_state_pass_plain",
           "ssd_chunk_scan_plain", "ssd_stages", "ssd_bwd", "ssd_bwd_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256       # bf16: 4 tiles of 64; float32: sweeps of 128 columns
MAX_CHUNK = 1024      # the chunk buffers must fit in a block's shared memory
TILE = 64             # the kernels' tile side


def _check(x, dt, A, Bm, Cm, state_in) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"want x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,G,N]; "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)} or B/C "
                         f"{tuple(Bm.shape)} do not match x {tuple(x.shape)}")
    if h % Bm.shape[2]:
        raise ValueError(f"{h} heads are not a multiple of {Bm.shape[2]} groups")
    if state_in is not None and tuple(state_in.shape) != (b, h, Bm.shape[3], p):
        raise ValueError(f"state_in {tuple(state_in.shape)} is not "
                         f"{(b, h, Bm.shape[3], p)}")
    tensors = [t for t in (x, dt, A, Bm, Cm, state_in) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B, C and state_in must share a device")


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[i,j] = sum_{j<k<=i} x[k] for i>=j else -inf.  x: [..., Q]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def _padded_chunks(x, dt, Bm, Cm, q):
    """Zero-pad S to whole chunks of q (dt = 0 past S: the state stays) and
    split it: x [B,nc,q,H,P], dt [B,nc,q,H], B/C [B,nc,q,H,N] repeated to
    heads, all float32."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    pad = (-s) % q
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // q
    rep = h // g
    return (x.reshape(b, nc, q, h, p).float(), dt.reshape(b, nc, q, h).float(),
            Bm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float(),
            Cm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float())


def ssd_plain(x, dt, A, Bm, Cm, *, chunk: int, state_in=None,
              return_state: bool = False):
    """Chunked SSD in float32, the reference model path's arithmetic.

    x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,G,N], optional state_in
    [B,H,N,P] -> y [B,S,H,P] in x's dtype (and the float32 final state).
    The ragged S edge is zero-padded with dt = 0, which leaves the state as
    it is.
    """
    _check(x, dt, A, Bm, Cm, state_in)
    b, s, h, p = x.shape
    n = Bm.shape[3]
    q = min(chunk, s)
    xc, dtc, Bc, Cc = _padded_chunks(x, dt, Bm, Cm, q)
    nc = xc.shape[1]
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if state_in is None else state_in.float())
    A = A.float()
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dtA = dtq * A[None, None, :]                          # [B,q,H]
        cums = torch.cumsum(dtA, dim=1)
        L = torch.exp(_segsum(dtA.transpose(1, 2)))           # [B,H,q,q]
        scores = torch.einsum("bihn,bjhn->bhij", Cq, Bq) * L
        xbar = xq * dtq[..., None]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xbar)
        decay_i = torch.exp(cums)                             # [B,q,H]
        y_inter = torch.einsum("bihn,bhnp->bihp", Cq * decay_i[..., None], state)
        decay_out = torch.exp(cums[:, -1:, :] - cums)
        state_c = torch.einsum("bjhn,bjhp->bhnp", Bq * decay_out[..., None], xbar)
        state = state * torch.exp(cums[:, -1, :])[:, :, None, None] + state_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :s].to(x.dtype)
    return (y, state) if return_state else y


def ssd_chunk_state_plain(x, dt, A, Bm, *, chunk: int):
    """Stage 1: ``cums`` [B,H,nc,q] (the cumulative sum of dt·A within each
    chunk of q = min(chunk, S)) and each chunk's own state ``Ŝ`` [B,H,nc,N,P]
    = Σ_j (B_j w_j)ᵀ x_j with w_j = dt_j·e^{cums[-1] − cums_j}, float32."""
    q = min(chunk, x.shape[1])
    xc, dtc, Bc, _ = _padded_chunks(x, dt, Bm, Bm, q)
    cums = torch.cumsum(dtc * A.float(), dim=2)                   # [B,nc,q,H]
    w = dtc * torch.exp(cums[:, :, -1:] - cums)
    shat = torch.einsum("bcjhn,bcjhp->bhcnp", Bc * w[..., None], xc)
    return cums.permute(0, 3, 1, 2), shat


def ssd_state_pass_plain(shat, last, state_in=None):
    """Stage 2: the carry.  ``shat`` [B,H,nc,N,P], ``last`` [B,H,nc] (each
    chunk's cums[-1]) -> (S_in [B,H,nc,N,P], the final state [B,H,N,P]) with
    S_in(0) = ``state_in`` or 0 and S_in(c+1) = S_in(c)·e^{last_c} + Ŝ_c."""
    state = (torch.zeros_like(shat[:, :, 0]) if state_in is None
             else state_in.float())
    s_in = []
    for c in range(shat.shape[2]):
        s_in.append(state)
        state = state * torch.exp(last[:, :, c])[..., None, None] + shat[:, :, c]
    return torch.stack(s_in, dim=2), state


def ssd_chunk_scan_plain(x, dt, Bm, Cm, cums, s_in, *, chunk: int):
    """Stage 3: y [B,S,H,P] in x's dtype from ``cums`` [B,H,nc,q] and the
    chunks' carried states ``s_in`` [B,H,nc,N,P]: y_i = e^{cums_i}(C S_in)_i +
    Σ_{j≤i} (C Bᵀ)_{ij} e^{cums_i − cums_j} dt_j x_j."""
    b, s, h, p = x.shape
    q = min(chunk, s)
    xc, dtc, Bc, Cc = _padded_chunks(x, dt, Bm, Cm, q)
    cs = cums.permute(0, 2, 3, 1)                                  # [B,nc,q,H]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # [B,nc,i,j,H]
    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.exp(diff.masked_fill(~keep[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L * dtc[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
    y = y + torch.exp(cs)[..., None] * torch.einsum("bcihn,bhcnp->bcihp", Cc, s_in)
    return y.reshape(b, -1, h, p)[:, :s].to(x.dtype)


def ssd_bwd_plain(x, dt, A, Bm, Cm, dy, *, chunk: int, state_in=None,
                  dstate=None):
    """The VJP of :func:`ssd_plain` in explicit formulas, float32: the
    cotangents ``dy`` [B,S,H,P] of y and ``dstate`` [B,H,N,P] (or None) of
    the final state -> (dx, ddt, dA, dB, dC, dstate_in or None).

    Per chunk (b and h dropped; cums_i = Σ_{k≤i} dt_k A, xbar_j = dt_j x_j,
    W_ij = (C_i·B_j) e^{cums_i − cums_j} and G_ij = dy_i·xbar_j for j ≤ i,
    S_in the carried state, dS_out the next chunk's dS_in or ``dstate``):
    dxbar_j = Σ_{i≥j} W_ij dy_i + e^{last − cums_j} dS_outᵀ B_j;
    dC_i = Σ_{j≤i} G_ij e^{cums_i − cums_j} B_j + e^{cums_i} S_in dy_i;
    dB_j = Σ_{i≥j} G_ij e^{cums_i − cums_j} C_i + e^{last − cums_j} dS_out xbar_j;
    dS_in = e^{last} dS_out + Σ_i e^{cums_i} C_i dy_iᵀ (the reverse carry);
    dcums_i = Σ_j R_ij − Σ_j R_ji + e^{cums_i} C_i·(S_in dy_i) − v_i with
    R = W∘G and v_j = e^{last − cums_j} B_j·(dS_out xbar_j), plus Σ_j v_j +
    e^{last}⟨S_in, dS_out⟩ at the chunk's last row; d(dtA) is the reverse
    cumsum of dcums, ddt = A d(dtA) + x·dxbar, dx = dt dxbar, dA = Σ dt
    d(dtA).  dB and dC sum over each group's heads.
    """
    _check(x, dt, A, Bm, Cm, state_in)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    xc, dtc, Bc, Cc = _padded_chunks(x, dt, Bm, Cm, q)          # [B,nc,q,H,*]
    nc = xc.shape[1]
    dyc = F.pad(dy.float(), (0, 0, 0, 0, 0, nc * q - s)).reshape(b, nc, q, h, p)
    A = A.float()
    cums = torch.cumsum(dtc * A, dim=2)                          # [B,nc,q,H]
    last = cums[:, :, -1]                                        # [B,nc,H]
    xbar = xc * dtc[..., None]
    e_in = torch.exp(cums)
    e_out = torch.exp(last[:, :, None] - cums)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if state_in is None else state_in.float())
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", Bc[:, c] * e_out[:, c, ..., None], xbar[:, c])
    dS = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if dstate is None else dstate.float())
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = dS
        dS = dS * torch.exp(last[:, c])[..., None, None] + torch.einsum(
            "bihn,bihp->bhnp", Cc[:, c] * e_in[:, c, ..., None], dyc[:, c])
    s_in, ds_out = torch.stack(s_in, 1), torch.stack(ds_out, 1)  # [B,nc,H,N,P]

    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # [B,nc,i,j,H]
    E = torch.exp(diff.masked_fill(~keep[None, None, :, :, None], float("-inf")))
    W = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * E
    Z = torch.einsum("bcihp,bcjhp->bcijh", dyc, xbar) * E       # G∘E
    R = W * torch.einsum("bcihp,bcjhp->bcijh", dyc, xbar)
    dxbar = torch.einsum("bcijh,bcihp->bcjhp", W, dyc) + e_out[..., None] * \
        torch.einsum("bcjhn,bchnp->bcjhp", Bc, ds_out)
    w_in = torch.einsum("bchnp,bcihp->bcihn", s_in, dyc)         # S_in dy_i
    u_out = torch.einsum("bchnp,bcjhp->bcjhn", ds_out, xbar)     # dS_out xbar_j
    dC = torch.einsum("bcijh,bcjhn->bcihn", Z, Bc) + e_in[..., None] * w_in
    dB = torch.einsum("bcijh,bcihn->bcjhn", Z, Cc) + e_out[..., None] * u_out
    v = e_out * (Bc * u_out).sum(-1)
    dcums = R.sum(3) - R.sum(2) + e_in * (Cc * w_in).sum(-1) - v
    dcums[:, :, -1] += v.sum(2) + torch.exp(last) * (s_in * ds_out).sum((-1, -2))
    ddta = torch.flip(torch.cumsum(torch.flip(dcums, (2,)), 2), (2,))
    dx = dtc[..., None] * dxbar
    ddt = A * ddta + (xc * dxbar).sum(-1)
    dA = (dtc * ddta).sum((0, 1, 2))
    rep = h // g

    def seq(t):
        return t.reshape(b, nc * q, *t.shape[3:])[:, :s]

    dB = dB.reshape(b, nc, q, g, rep, n).sum(4)
    dC = dC.reshape(b, nc, q, g, rep, n).sum(4)
    return (seq(dx), seq(ddt), dA, seq(dB), seq(dC),
            None if state_in is None else dS)


def _last_two_contiguous(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, state_in=None,
        return_state: bool = False):
    """SSD: x [B,S,H,P], dt [B,S,H] float32, A [H] float32, Bm/Cm [B,S,G,N]
    -> y [B,S,H,P] in x's dtype, and the float32 final state [B,H,N,P] if
    ``return_state``; ``state_in`` [B,H,N,P] float32 seeds the state.

    CPU tensors take :func:`ssd_plain`; CUDA tensors launch the Hopper
    kernels (x, B, C float32 or bfloat16 with their last two dims
    contiguous; N <= 256, chunk <= 1024) or raise.  Where grad mode is on
    and an input requires a gradient, a CUDA call runs the float32 kernels
    through :class:`_SSD`, whose backward is :func:`ssd_bwd`, whatever x's
    dtype: bfloat16 x, B and C are cast to float32 (exact) and y comes back
    in x's dtype, as the reference's ``ssd_chunked`` scans in float32.
    Without grad, bfloat16 runs the bf16 kernels.  ``ssd.launches`` counts
    the forward calls that launched the kernels (one a call).
    """
    _check(x, dt, A, Bm, Cm, state_in)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk, state_in=state_in,
                         return_state=return_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD kernel for device {x.device}")
    q = _check_kernel_inputs(x, dt, A, Bm, Cm, state_in, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, state_in)):
        # float32 whatever x's dtype, as the reference's ssd_chunked scans
        out = _SSD.apply(x.float(), dt, A, Bm.float(), Cm.float(), state_in, q,
                         return_state)
        y = out[0].to(x.dtype)
        return (y, out[1]) if return_state else y
    y, state_out, _ = _launch(x, dt, A, Bm, Cm, q, state_in, return_state)
    if x.is_cuda:
        ssd.launches += 1
    return (y, state_out) if return_state else y


ssd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, dy, *, chunk: int = 256, state_in=None,
            dstate=None):
    """(dx, ddt, dA, dB, dC, dstate_in or None) of the SSD from the
    cotangents ``dy`` [B,S,H,P] of y and ``dstate`` [B,H,N,P] (or None) of
    the final state, float32; the forward's inputs are given again (the
    backward recomputes the carried states).

    CPU tensors take :func:`ssd_bwd_plain`; CUDA tensors launch the
    backward kernels (float32; x, B, C with their last two dims contiguous,
    dt, A, dy and the states contiguous; N <= 256, chunk <= 1024) or raise.
    ``ssd_bwd.launches`` counts its calls (seven kernel launches each).
    """
    _check(x, dt, A, Bm, Cm, state_in)
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=chunk,
                             state_in=state_in, dstate=dstate)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD kernel for device {x.device}")
    q = _check_kernel_inputs(x, dt, A, Bm, Cm, state_in, chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    for name, t, shape in (("dy", dy, (b, s, h, p)), ("dstate", dstate, (b, h, n, p))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float32 {shape} on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"the backward kernels take float32; got {x.dtype}")
    if x.device.type == "meta":          # the dry-run's count, no launch
        grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
                 torch.empty_like(Bm), torch.empty_like(Cm),
                 None if state_in is None else torch.empty_like(state_in))
        cost.record("ssd_bwd", cost.ssd_bwd_flops(
            b, s, h, g, n, p, q, state_in is not None, dstate is not None),
            cost.nbytes(x, dt, A, Bm, Cm, state_in, dy, dstate, *grads))
        return grads
    nc = -(-s // q)
    pieces, nbytes = _bwd_workspace(b, s, h, g, n, p, q)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dA = torch.empty((h,), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, s, g, n), dtype=torch.float32, device=x.device)
    dC = torch.empty((b, s, g, n), dtype=torch.float32, device=x.device)
    d_in = None if state_in is None else torch.empty_like(state_in)
    lib = build.load()
    err = lib.ssd_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if state_in is None else state_in.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        None if d_in is None else d_in.data_ptr(),
        *[ws.data_ptr() + off for off, _ in pieces], _counters(x.device, b, h, p),
        b, s, h, g, n, p, q, nc, x.stride(0), x.stride(1), Bm.stride(0),
        Bm.stride(1), Cm.stride(0), Cm.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd_bwd")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, d_in


ssd_bwd.launches = 0


def _bwd_workspace(b, s, h, g, n, p, q):
    """The backward kernels' scratch, in the order of ``ssd_chunk_bwd``'s
    ws0..ws11, as (byte offset, float32 count), each 256-byte aligned; and
    the buffer's size (qp = q rounded up to 64): cums [BH, nc, qp] and
    cums[-1] [BH, nc]; the carried states S_in and the reverse carry dS_out
    per chunk [BH, nc, N, P] (each written in place over the chunk's own
    contribution); C Bᵀ [B·G, nc, qp, qp]; per-head dB and dC [B, S, H, N];
    the pair passes' row and column parts of dcums, v and x·dxbar [BH, nc,
    qp]; each (batch·head, chunk)'s part of dA [BH, nc]."""
    nc = -(-s // q)
    qp = _round_up(q)
    bh, sq = b * h, nc * qp
    counts = [bh * sq, bh * nc, bh * nc * n * p, bh * nc * n * p, b * g * nc * qp * qp,
              b * s * h * n, b * s * h * n, bh * sq, bh * sq, bh * sq, bh * sq, bh * nc]
    out, off = [], 0
    for c in counts:
        out.append((off, c))
        off += -(-c * 4 // 256) * 256
    return out, off


class _SSD(torch.autograd.Function):
    """K4 with its gradient on CUDA tensors: the float32 forward saves its
    inputs (never y); the backward is :func:`ssd_bwd`, with the final
    state's cotangent when the state is returned and used."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state_in, q, return_state):
        y, state_out, _ = _launch(x, dt, A, Bm, Cm, q, state_in, return_state)
        if x.is_cuda:
            ssd.launches += 1
        ctx.save_for_backward(x, dt, A, Bm, Cm, state_in)
        ctx.q = q
        ctx.set_materialize_grads(False)
        return y, state_out

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, state_in = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        dx, ddt, dA, dB, dC, d_in = ssd_bwd(x, dt, A, Bm, Cm, dy, chunk=ctx.q,
                                            state_in=state_in, dstate=dstate)
        return dx, ddt, dA, dB, dC, d_in, None, None


def _check_kernel_inputs(x, dt, A, Bm, Cm, state_in, chunk: int) -> int:
    """Raise on what the kernels do not take; return the chunk length."""
    b, s = x.shape[:2]
    n = Bm.shape[3]
    q = min(chunk, s)
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"kernel takes x, B, C of one dtype in {_DTYPES}; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            state_in is not None and state_in.dtype != torch.float32):
        raise ValueError("kernel takes dt, A and state_in in float32")
    if not (_last_two_contiguous(x) and _last_two_contiguous(Bm)
            and _last_two_contiguous(Cm) and dt.is_contiguous()
            and A.is_contiguous()
            and (state_in is None or state_in.is_contiguous())):
        raise ValueError("kernel takes x, B, C with contiguous last two dims "
                         "and contiguous dt, A, state_in")
    if n > MAX_STATE or q > MAX_CHUNK or b == 0 or s == 0:
        raise ValueError(f"kernel takes 0 < N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK} and a non-empty input; got N={n}, "
                         f"chunk {q}, {tuple(x.shape)}")
    return q


def _round_up(v: int) -> int:
    return -(-v // TILE) * TILE


def _workspace(b, s, h, g, n, p, q, bf16: bool):
    """The pieces of the kernels' one workspace buffer, in the order of
    ``ssd_chunk_fwd``'s ws0..ws4: (byte offset, dtype, shape) each, each
    piece 256-byte aligned; and the buffer's size.  bf16: cums, cums[-1],
    the chunk states Ŝ, and S_in's two bf16 halves in the [P tiles, N
    rounded up to 64, 64] layout that the scan kernel copies whole.
    float32: C Bᵀ per (batch·group, chunk) in [q, q] blocks (q rounded up to
    64), cums, cums[-1], and the chunk states Ŝ, which the carry overwrites
    with S_in per chunk; ``ssd_chunk_fwd``'s ws4 is then unused."""
    nc = -(-s // q)
    qp = _round_up(q)
    if bf16:
        half = (torch.bfloat16, (b * h, nc, _round_up(p) // TILE, _round_up(n), TILE))
        pieces = [(torch.float32, (b * h, nc, qp)),
                  (torch.float32, (b * h, nc)),
                  (torch.float32, (b * h, nc, n, p)), half, half]
    else:
        pieces = [(torch.float32, (b * g, nc, qp, qp)),
                  (torch.float32, (b * h, nc, qp)),
                  (torch.float32, (b * h, nc)),
                  (torch.float32, (b * h, nc, n, p))]
    out, off = [], 0
    for dtype, shape in pieces:
        out.append((off, dtype, shape))
        off += -(-torch.Size(shape).numel() * dtype.itemsize // 256) * 256
    return out, off


def _launch(x, dt, A, Bm, Cm, q, state_in, return_state):
    """One call of ``ssd_chunk_fwd`` (two launches in bf16, three in
    float32): (y, the final state or None, (workspace buffer, its pieces))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if x.device.type == "meta":          # the dry-run's count, no launch
        y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
        state_out = (torch.empty((b, h, n, p), dtype=torch.float32,
                                 device=x.device) if return_state else None)
        cost.record("ssd", cost.ssd_flops(b, s, h, g, n, p, q, state_in is not None,
                                          return_state)[0],
                    cost.nbytes(x, dt, A, Bm, Cm, state_in, y, state_out))
        return y, state_out, None
    pieces, nbytes = _workspace(b, s, h, g, n, p, q, x.dtype == torch.bfloat16)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    ptrs = [ws.data_ptr() + off for off, _, _ in pieces]
    ptrs += [None] * (5 - len(ptrs))         # float32 has no ws4
    # the carry's ticket counters, one per (batch·head, 64 columns of P)
    ptrs.append(_counters(x.device, b, h, p))
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state_out = (torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
                 if return_state else None)
    lib = build.load()
    err = lib.ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if state_in is None else state_in.data_ptr(), y.data_ptr(),
        None if state_out is None else state_out.data_ptr(), *ptrs,
        int(x.dtype == torch.bfloat16), b, s, h, g, n, p, q,
        x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
        Cm.stride(1), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd")
    return y, state_out, (ws, pieces)


def _counters(device, b, h, p) -> int:
    """The ticket counters of the state carries (both dtypes, forward and
    backward): zeroed, left at zero by every call."""
    return build.counters("ssd", device, b * h * (_round_up(p) // TILE)).data_ptr()


def ssd_stages(x, dt, A, Bm, Cm, *, chunk: int = 256, state_in=None) -> dict:
    """The kernels' stages on the card (bf16 or float32), for holding each
    against its plain version: one call of the kernels, then their
    workspaces as ``cums`` [B,H,nc,q], ``last`` [B,H,nc] and ``shat``
    [B,H,nc,N,P] (chunk states; None in float32, whose carry writes S_in
    over them), ``s_in`` [B,H,nc,N,P] (the carry's S_in per chunk; bf16:
    its hi + lo in float32; chunk 0's is ``state_in`` or 0) and ``state``
    (the carry), and ``y`` (the chunk scan).  Not on the model
    path: ``ssd_stages.launches`` counts its calls apart from ``ssd``'s."""
    _check(x, dt, A, Bm, Cm, state_in)
    if x.device.type != "cuda":
        raise ValueError("ssd_stages runs the kernels on CUDA tensors")
    q = _check_kernel_inputs(x, dt, A, Bm, Cm, state_in, chunk)
    b, _, h, p = x.shape
    n = Bm.shape[3]
    y, state, (ws, pieces) = _launch(x, dt, A, Bm, Cm, q, state_in, True)
    ssd_stages.launches += 1
    views = [ws[off:off + torch.Size(shape).numel() * dtype.itemsize].view(dtype).view(shape)
             for off, dtype, shape in pieces]

    def heads(t):
        return t.reshape(b, h, *t.shape[1:])

    if x.dtype == torch.float32:
        _, cums, last, s_in = views
        shat = None
    else:
        cums, last, shat, hi, lo = views
        s_in = (hi.float() + lo.float()).permute(0, 1, 3, 2, 4).flatten(3)[..., :n, :p]
        if state_in is None:    # chunk 0's S_in is 0; the kernel does not write it
            s_in[:, 0] = 0.0
    return dict(cums=heads(cums[..., :q]), last=heads(last),
                shat=None if shat is None else heads(shat),
                s_in=heads(s_in), state=state, y=y)


ssd_stages.launches = 0
