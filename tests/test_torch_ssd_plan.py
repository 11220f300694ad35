"""K4's float32 kernels and K4's backward: their decomposition and arithmetic, on the CPU.

The kernels (``csrc/ssd_chunk.cu``'s float32 instance and
``csrc/ssd_chunk_bwd.cu``) run only on the card; what decides their result
besides the card's arithmetic is checked here:

- the reverse state pass's plain stages, each chunk's own cotangent dŜ_c
  (``ssd_chunk_dstate_plain``) and then the reverse carry
  (``ssd_dstate_pass_plain``), written out here, composed equal
  ``ssd_bwd_plain``'s dS_out per chunk and d state_in to 1e-6
  (``ssd_bwd_plain`` is held against ``jax.vjp`` of the reference's
  ``ssd_chunked`` in tests/test_torch_recurrent_training.py);
- the kernels' decomposition (C Bᵀ once per chunk, the chunk-parallel state
  passes, the forward's y pass, the backward's column and row passes) with
  every product in the kernels' 3xTF32 split, emulated in torch, meets the
  kernels' tolerance, 1e-4 of each output's largest value against float64,
  at Mamba-2's widths; one TF32 product misses it;
- the backward's products done, counted from its kernels' loop bounds,
  stay within 1.25x of what the function needs at Mamba-2's training shape.

The card holds the kernels themselves against the plain versions
(tests/test_torch_kernels_cuda.py::test_ssd_kernel_matches_plain and
::test_ssd_bwd_kernel_matches_plain).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_chunk as k4


def _inputs(b, s, h, g, n, p, dt_scale, seed):
    """x, dt, A, B, C, state_in, dy, dS_final as the card tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.0, h, dtype=np.float32))
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    st = rng.standard_normal((b, h, n, p), dtype=np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    ds = rng.standard_normal((b, h, n, p), dtype=np.float32)
    return [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, a, bm, cm, st, dy, ds)]


# --------------------------------------------------------------------------- #
# the reverse state pass
# --------------------------------------------------------------------------- #
def ssd_chunk_dstate_plain(dy, dt, A, Cm, *, chunk: int):
    """The reverse state pass's first stage: ``cums`` [B,H,nc,q] and each
    chunk's own cotangent ``dŜ`` [B,H,nc,N,P] = Σ_i (C_i e^{cums_i}) dy_iᵀ,
    float32 (the backward kernel's state pass, reversed)."""
    q = min(chunk, dy.shape[1])
    dyc, dtc, _, Cc = k4._padded_chunks(dy, dt, Cm, Cm, q)
    cums = torch.cumsum(dtc * A.float(), dim=2)                   # [B,nc,q,H]
    dshat = torch.einsum("bcihn,bcihp->bhcnp", Cc * torch.exp(cums)[..., None], dyc)
    return cums.permute(0, 3, 1, 2), dshat


def ssd_dstate_pass_plain(dshat, last, dstate=None):
    """The reverse carry.  ``dshat`` [B,H,nc,N,P], ``last`` [B,H,nc] (each
    chunk's cums[-1]) -> (dS_out [B,H,nc,N,P], d state_in [B,H,N,P]) with
    dS_out(nc-1) = ``dstate`` or 0, dS_out(c-1) = dS_out(c)·e^{last_c} +
    dŜ_c, and d state_in the carry past chunk 0."""
    ds = torch.zeros_like(dshat[:, :, 0]) if dstate is None else dstate.float()
    ds_out = [None] * dshat.shape[2]
    for c in reversed(range(dshat.shape[2])):
        ds_out[c] = ds
        ds = ds * torch.exp(last[:, :, c])[..., None, None] + dshat[:, :, c]
    return torch.stack(ds_out, dim=2), ds


@pytest.mark.parametrize("dt_scale", [1.0, 0.02], ids=["fast", "slow-decay"])
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [37, 64])
def test_reverse_state_stages_compose_to_the_plain_backward(s, g, with_state,
                                                            with_dstate, dt_scale):
    """Each chunk's dŜ_c, then the reverse carry, give ``ssd_bwd_plain``'s
    d state_in and, chunk by chunk, the cotangent dS_out(c) of the state
    chunk c hands on: the d state_in of the same backward run from chunk
    c + 1 on (dS_out of the last chunk is dS_final or 0)."""
    b, h, n, p, chunk = 2, 4, 8, 8, 16
    x, dt, a, bm, cm, st, dy, ds = _inputs(b, s, h, g, n, p, dt_scale, s + 10 * g)
    st = st if with_state else torch.zeros_like(st)
    ds = ds if with_dstate else None
    cums, dshat = ssd_chunk_dstate_plain(dy, dt, a, cm, chunk=chunk)
    ds_out, d_in = ssd_dstate_pass_plain(dshat, cums[..., -1], ds)
    nc = -(-s // chunk)
    assert cums.shape == (b, h, nc, chunk) and ds_out.shape == (b, h, nc, n, p)

    want_in = k4.ssd_bwd_plain(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st,
                               dstate=ds)[5]
    scale = float(want_in.abs().max())
    assert float((d_in - want_in).abs().max()) <= 1e-6 * scale
    for c in range(nc):
        c1 = (c + 1) * chunk
        if c1 >= s:
            want = torch.zeros_like(st) if ds is None else ds
        else:
            want = k4.ssd_bwd_plain(x[:, c1:], dt[:, c1:], a, bm[:, c1:], cm[:, c1:],
                                    dy[:, c1:], chunk=chunk,
                                    state_in=torch.zeros_like(st), dstate=ds)[5]
        assert float((ds_out[:, :, c] - want).abs().max()) <= 1e-6 * max(scale, 1e-30)


# --------------------------------------------------------------------------- #
# the kernels' products, emulated
# --------------------------------------------------------------------------- #
def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """(big, small), x ~= big + small, both TF32: the kernels' split
    (tf32x3.cuh) clears big's low 13 bits and rounds small to nearest (half
    a TF32 ulp added, the tensor core truncating)."""
    big = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return big, _tf32(x - big)


def _product(a, b, mode):
    """a @ b in float64, float32, one TF32 product, or the kernels' 3xTF32
    split (the two cross terms first, then big * big)."""
    if mode in ("f64", "f32"):
        return a @ b
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _chunks(s, q):
    return [(c0, min(q, s - c0)) for c0 in range(0, s, q)]


def _state_pass(u, v, om, cums_l, init, q, mode, rev):
    """The state pass of one head: per chunk U_cᵀ (om_c V_c) (a product over
    the chunk's steps), then the carry in the working type; returns the
    carried value per chunk (S_in, or dS_out) and the final one."""
    own = [_product(u[c0:c0 + ln].T, om[c0:c0 + ln, None] * v[c0:c0 + ln], mode)
           for c0, ln in _chunks(u.shape[0], q)]
    order = range(len(own) - 1, -1, -1) if rev else range(len(own))
    carried, state = [None] * len(own), init
    for c in order:
        carried[c] = state
        state = state * torch.exp(cums_l[c]) + own[c]
    return carried, state


def _emulated(x, dt, a, bm, cm, st, dy, ds, q, mode):
    """K4's float32 forward (y, the final state) and backward (dx, ddt, dA,
    dB, dC, d state_in) for one head (x, dy [S, P]; dt [S]; B, C [S, N];
    state_in, dS_final [N, P]) in the kernels' decomposition, every product
    in ``mode`` and everything else in float32 (float64 for the truth)."""
    wt = torch.float64 if mode == "f64" else torch.float32
    x, dt, a, bm, cm, st, dy, ds = (t.to(wt) for t in (x, dt, a, bm, cm, st, dy, ds))
    s = x.shape[0]
    cums = torch.cat([torch.cumsum(dt[c0:c0 + ln] * a, 0) for c0, ln in _chunks(s, q)])
    lasts = [cums[c0 + ln - 1] for c0, ln in _chunks(s, q)]
    om_f = torch.cat([dt[c0:c0 + ln] * torch.exp(cums[c0 + ln - 1] - cums[c0:c0 + ln])
                      for c0, ln in _chunks(s, q)])
    s_in, final = _state_pass(bm, x, om_f, lasts, st, q, mode, rev=False)
    ds_out, d_in = _state_pass(cm, dy, torch.exp(cums), lasts, ds, q, mode, rev=True)
    y, dx, ddt, dbm, dcm, da = [], [], [], [], [], 0.0
    for c, (c0, ln) in enumerate(_chunks(s, q)):
        sl = slice(c0, c0 + ln)
        xc, dtc, bc, cc, dyc, cu = x[sl], dt[sl], bm[sl], cm[sl], dy[sl], cums[sl]
        keep = torch.tril(torch.ones((ln, ln), dtype=torch.bool))
        e = torch.where(keep, torch.exp((cu[:, None] - cu[None, :]).masked_fill(~keep, 0)),
                        torch.zeros((), dtype=wt))
        cb = _product(cc, bc.T, mode)                 # C Bᵀ once per chunk
        xbar = dtc[:, None] * xc
        e_in, w = torch.exp(cu), torch.exp(lasts[c] - cu)
        # forward: the y pass
        y.append(e_in[:, None] * _product(cc, s_in[c], mode) + _product(cb * e, xbar, mode))
        # backward: the column pass (rows j) and the row pass (rows i)
        gt = _product(xbar, dyc.T, mode)              # Gᵀ [j, i]
        wm, zt = cb * e, gt.T * e                     # W [i, j], Z [i, j]
        u = _product(xbar, ds_out[c].T, mode)         # xbar_J dS_outᵀ [j, n]
        dxbar = _product(wm.T, dyc, mode) + w[:, None] * _product(bc, ds_out[c], mode)
        dbm.append(_product(zt.T, cc, mode) + w[:, None] * u)
        g_rows = _product(dyc, xbar.T, mode)          # G, the row pass's own
        sdy = _product(dyc, s_in[c].T, mode)          # dy_I S_inᵀ [i, n]
        dcm.append(_product(g_rows * e, bc, mode) + e_in[:, None] * sdy)
        v = w * (bc * u).sum(-1)
        dcums = (wm * g_rows).sum(1) - (wm * gt.T).sum(0) + e_in * (cc * sdy).sum(-1) - v
        dcums[-1] += v.sum() + torch.exp(lasts[c]) * (s_in[c] * ds_out[c]).sum()
        ddta = torch.flip(torch.cumsum(torch.flip(dcums, (0,)), 0), (0,))
        dx.append(dtc[:, None] * dxbar)
        ddt.append(a * ddta + (xc * dxbar).sum(-1))
        da = da + (dtc * ddta).sum()
    cat = torch.cat
    return cat(y), final, cat(dx), cat(ddt), da, cat(dbm), cat(dcm), d_in


@pytest.mark.parametrize("dt_scale", [1.0, 0.01], ids=["fast", "slow-decay"])
@pytest.mark.parametrize("mode,meets", [("3xtf32", True), ("f32", True),
                                        ("tf32", False)])
def test_3xtf32_products_meet_the_tolerance(mode, meets, dt_scale):
    """Mamba-2's widths (N=128, P=64, chunk 256, S=512) for one head, with
    state_in and dS_final, against float64: the kernels' 3xTF32 split and
    float32 meet the kernels' 1e-4 of each output's largest value; one TF32
    product misses it, which is why the kernels split."""
    x, dt, a, bm, cm, st, dy, ds = _inputs(1, 512, 1, 1, 128, 64, dt_scale, 7)
    args = (x[0, :, 0], dt[0, :, 0], a[0], bm[0, :, 0], cm[0, :, 0], st[0, 0],
            dy[0, :, 0], ds[0, 0], 256)
    truth = _emulated(*args, "f64")
    got = _emulated(*args, mode)
    err = max(float((u.double() - t).abs().max() / t.abs().max()) for u, t in zip(got, truth))
    assert (err <= 1e-4) == meets, err


def test_emulated_decomposition_is_the_plain_function():
    """The decomposition the emulation (and the kernels) follow, in float64,
    is ``ssd_plain`` and ``ssd_bwd_plain`` (ragged S, two chunks), which
    compute in float32: 1e-5 of each output's largest value."""
    x, dt, a, bm, cm, st, dy, ds = (t.double() for t in _inputs(1, 200, 1, 1, 16, 8,
                                                                 0.3, 3))
    got = _emulated(x[0, :, 0], dt[0, :, 0], a[0], bm[0, :, 0], cm[0, :, 0], st[0, 0],
                    dy[0, :, 0], ds[0, 0], 128, "f64")
    y, final = k4.ssd_plain(x, dt, a, bm, cm, chunk=128, state_in=st, return_state=True)
    dx, ddt, da, dbm, dcm, d_in = k4.ssd_bwd_plain(x, dt, a, bm, cm, dy, chunk=128,
                                                  state_in=st, dstate=ds)
    want = (y[0, :, 0], final[0, 0], dx[0, :, 0], ddt[0, :, 0], da[0], dbm[0, :, 0],
            dcm[0, :, 0], d_in[0, 0])
    for u, w in zip(got, want):
        assert float((u - w.double()).abs().max()) <= 1e-5 * float(w.abs().max())


# --------------------------------------------------------------------------- #
# the backward's products done against those needed
# --------------------------------------------------------------------------- #
def _ceil(v, m):
    return -(-v // m) * m


def _bwd_products(b, s, h, g, n, p, chunk, with_state, with_dstate):
    """(needed, done): K4's backward's float32 products in operations (2 a
    multiply-add).  Needed as chip_smoke.py's ``ssd_bwd_flops`` counts them:
    the lower triangles of C Bᵀ (once per group), G, Wᵀ dy, Zᵀ C and Z B,
    and the [q, N] x [N, P] products whose operands are live.  Done, from
    the kernels' loop bounds (csrc/ssd_chunk_bwd.cu, csrc/ssd_chunk.cu): C Bᵀ
    on whole 64 x 64 tiles on and below the diagonal; a column-pass warp (16
    rows j from R) covers i in [R, the block's last half tile) and a
    row-pass warp (16 rows i from R) j in [0, min(R + 16, its last half
    tile)), each computing G (over P) for its own use, the column pass Wᵀ dy
    and Zᵀ C, the row pass Z B; the state products on whole tiles, live ones
    only (a dead chunk's own state is skipped)."""
    q = min(chunk, s)
    qp, nc = _ceil(q, 64), -(-s // q)
    nw = 128 if n >= 128 else _ceil(n, 32)
    nsw_col, nsw_row = max(-(-p // 64), -(-n // nw)), -(-n // nw)
    pk, nk = _ceil(p, 8), _ceil(n, 8)
    need = done = 0
    for c in range(nc):
        ln = min(q, s - c * q)
        tri = ln * (ln + 1) // 2
        live_hat, live_dhat = c < nc - 1, c > 0 or with_state
        live_sin, live_dsout = c > 0 or with_state, c < nc - 1 or with_dstate
        need += b * g * tri * n + b * h * (tri * (2 * p + 2 * n) + ln * n * p * (
            live_hat + live_dhat + live_sin + 2 * live_dsout))
        nt = qp // 64
        done += b * g * nt * (nt + 1) // 2 * 64 * 64 * nk
        state_rows = _ceil(ln, 32) * _ceil(n, 16) * 64 * -(-p // 64)
        done += b * h * state_rows * (live_hat + live_dhat)
        for t in range(-(-ln // 64)):
            t0 = 64 * t
            col_end = t0 + 32 * -(-(ln - t0) // 32)
            row_end = 32 * min(2 * t + 2, -(-ln // 32))
            for r in range(t0, t0 + 64, 16):
                done += b * h * 16 * max(0, col_end - r) * nsw_col * (pk + 64 + nw)
                done += b * h * 16 * min(r + 16, row_end) * nsw_row * (pk + nw)
            done += b * h * 64 * (nsw_col * (nw * pk + 64 * nk) * live_dsout
                                  + nsw_row * nw * pk * live_sin)
    return 2 * need, 2 * done


def test_bwd_products_done_within_allowance_at_training_shape():
    """At Mamba-2's training shape (B=2, S=512, H=64, P=64, G=1, N=128,
    chunk 256, no state_in, no dS_final) the backward does at most 1.25x
    the products the function needs (whole 8-column blocks on the diagonal
    tiles, G computed by both pair passes), and never fewer."""
    need, done = _bwd_products(2, 512, 64, 1, 128, 64, 256, False, False)
    assert need == 9_185_656_832       # chip_smoke.py's ssd_bwd_flops
    assert need <= done <= 1.25 * need, done / need
