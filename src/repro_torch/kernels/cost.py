"""Operations and bytes of the Hopper kernels, from their inputs' shapes.

One copy of each kernel's count, read by ``chip_smoke.py``'s bound column
(the least time the card could take for a call: bytes over the HBM rate or
operations over the peak of their type) and by the kernels' ``meta``
branches, which the dry-run (``launch/dryrun.py``) runs: a ``meta`` call
returns an empty result of the kernel's output shape and adds its
operations and bytes to the innermost :func:`kernel_tally`.

Operations count what the input needs (a causal mask's live pairs, a
window's, the SSD's lower triangles and live state terms), not the most a
kernel could do.  Bytes: each input read once, each output written once.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["attention_pairs", "decode_attention_bytes", "decode_attention_ops",
           "dequantize_ops", "flash_attention_bwd_ops", "flash_attention_ops",
           "kernel_tally", "nbytes", "quantize_ops", "record", "rglru_bwd_ops",
           "rglru_ops", "ssd_bwd_flops", "ssd_flops"]


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: key k is live for query q where
    ``k <= q`` (causal) and ``k > q - window`` (window > 0)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    w = window
    if causal:                    # min(q + 1, w) keys for query q
        return w * (w + 1) // 2 + (s - w) * w
    # keys in (q - w, s): s - max(0, q - w + 1) of them
    late = s - w + 1              # queries q >= w - 1
    return s * s - (late - 1) * late // 2


def flash_attention_ops(b: int, s: int, h: int, dqk: int, dv: int,
                        causal: bool = True, window: int = 0) -> float:
    """K1's forward: q kᵀ over dqk and p v over dv for every live pair."""
    return 2.0 * (dqk + dv) * b * h * attention_pairs(s, causal, window)


def flash_attention_bwd_ops(b: int, s: int, h: int, dqk: int, dv: int,
                            causal: bool = True, window: int = 0) -> float:
    """K1's backward: s, dK and dQ reduce over dqk, dP and dV over dv."""
    return 2.0 * (3 * dqk + 2 * dv) * b * h * attention_pairs(s, causal, window)


def decode_attention_ops(b: int, h: int, cur: int, hd: int) -> float:
    """K3: q kᵀ and p v over the ``cur`` valid cache entries."""
    return 4.0 * b * h * cur * hd


def decode_attention_bytes(b: int, cur: int, kv: int, hd: int, q_numel: int,
                           element_size: int) -> int:
    """K3: the valid k and v cache entries read, q read and o written."""
    return (2 * b * cur * kv * hd + 2 * q_numel) * element_size


def ssd_flops(b, s, h, g, n, p, chunk, with_state=False,
              return_state=False) -> tuple[float, float]:
    """(products this input needs: lower triangles, C B^T once per group,
    the C S_in term only where S_in is live (after chunk 0, or from
    state_in) and a chunk's own state only where it feeds a later chunk or
    the returned final state; the TPU kernel's count: full Q x Q tiles,
    C B^T per head, both state products in every chunk)."""
    need = tpu = 0.0
    starts = range(0, s, min(chunk, s))
    for c, c0 in enumerate(starts):
        q = min(chunk, s - c0)
        tri = q * (q + 1) / 2
        live = (c > 0 or with_state) + (c < len(starts) - 1 or return_state)
        need += 2 * b * (g * tri * n + h * (tri * p + live * q * n * p))
        tpu += 2 * b * h * (q * q * n + q * q * p + 2 * q * n * p)
    return need, tpu


def ssd_bwd_flops(b, s, h, g, n, p, chunk, with_state=False,
                  with_dstate=False) -> float:
    """Float32 operations K4's VJP needs at this input: per chunk the lower
    triangles of C B^T (once per group), dy xbar^T, W^T dy, Z^T C and Z B,
    and per head the [q, N] x [N, P] products whose operands are live: the
    chunk's own state (recomputed for S_in) where a later chunk reads it,
    its own dS^ where an earlier chunk's dS_out or d state_in (wanted only
    with state_in) reads it, the S_in term of dC where S_in is live (after
    chunk 0, or from state_in), and the dS_out terms of dxbar and dB where
    dS_out is live (before the last chunk, or from dS_final)."""
    ops = 0.0
    starts = range(0, s, min(chunk, s))
    nc = len(starts)
    for c, c0 in enumerate(starts):
        q = min(chunk, s - c0)
        tri = q * (q + 1) / 2
        hat_live = c < nc - 1
        s_in_live = c > 0 or with_state
        dhat_live = c > 0 or with_state       # d state_in comes with state_in
        ds_out_live = c < nc - 1 or with_dstate
        live = hat_live + dhat_live + s_in_live + 2 * ds_out_live
        ops += 2 * b * (g * tri * n + h * (tri * (2 * p + 2 * n) + live * q * n * p))
    return ops


def rglru_ops(numel: int) -> float:
    """K5: one multiply and one add a step and lane."""
    return 2.0 * numel


def rglru_bwd_ops(numel: int) -> float:
    """K5's backward: the reverse carry's multiply-add and da's product."""
    return 3.0 * numel


def quantize_ops(n: int, d: int) -> float:
    """K2a: abs, max, divide, round, clip (two compares) a value."""
    return 6.0 * n * d


def dequantize_ops(n: int, d: int) -> float:
    """K2b: convert and multiply a value."""
    return 2.0 * n * d


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (``None`` skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# --------------------------------------------------------------------------- #
# the meta branches' tally
# --------------------------------------------------------------------------- #
_TALLIES: list[dict] = []


@contextmanager
def kernel_tally():
    """Collects the kernels' ``meta`` calls in its body: ``{kernel name:
    {"calls", "ops", "bytes"}}``."""
    tally: dict = {}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def record(name: str, ops: float, n_bytes: float) -> None:
    """A ``meta`` call of kernel ``name``, added to the innermost tally."""
    if _TALLIES:
        row = _TALLIES[-1].setdefault(name, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["ops"] += float(ops)
        row["bytes"] += float(n_bytes)
