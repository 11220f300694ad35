"""The port's dry-run and the kernels' operation counts, on the CPU.

``model_flops`` equals the reference's for every arch × shape (the
reference's dry-run module sets ``XLA_FLAGS`` for 512 devices when
imported, so it is imported in a subprocess of its own).  The
llama3-8b, mamba2-1.3b and recurrentgemma-9b cells at ``train_4k`` and
``decode_32k`` run at full size on ``meta`` tensors with ``status: "ok"``,
the ratio of ``model_flops`` to the counted operations printed and inside
(0.3, 1.0]; each kernel's ``meta`` branch returns its output's shape, adds
``kernels/cost.py``'s count to the tally and counts no launch; the
per-chip param bytes equal the reference's ``NamedSharding.shard_shape``
sum; a failing cell is recorded and the sweep goes on.  ``cost.py``'s
counts are held at the shapes of PERF.md §6 and ``attention_pairs`` against
the mask it counts.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_bundle as jax_get_bundle
from repro.distributed.sharding import param_pspecs as jax_param_pspecs
from repro_torch.configs import ALL_ARCHS, get_bundle
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import int8_transfer as k2
from repro_torch.kernels import rglru as k5
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.launch import dryrun
from repro_torch.models.api import SHAPES

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ("llama3-8b", "mamba2-1.3b", "recurrentgemma-9b")
         for s in ("train_4k", "decode_32k")]


def test_model_flops_equal_the_reference():
    code = ("import json, sys; sys.path.insert(0, 'src');"
            "from repro.configs import get_bundle;"
            "from repro.launch.dryrun import model_flops;"
            "from repro.models.api import SHAPES;"
            f"print(json.dumps({{a: {{n: model_flops(get_bundle(a), s) for n, s in "
            f"SHAPES.items()}} for a in {list(ALL_ARCHS)!r}}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    for arch in ALL_ARCHS:
        for name, shape in SHAPES.items():
            assert dryrun.model_flops(get_bundle(arch), shape) == ref[arch][name]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_runs_on_meta_at_full_size(arch, shape, tmp_path):
    launches = [f.launches for f in (k1.flash_attention, k1.flash_attention_bwd,
                                     k3.decode_attention, k4.ssd, k4.ssd_bwd,
                                     k5.rglru, k5.rglru_bwd)]
    rec = dryrun.run_cell(arch, shape, "pod", tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    saved = json.loads((tmp_path / f"{arch}__{shape}__pod.json").read_text())
    assert saved["useful_flops_ratio"] == rec["useful_flops_ratio"]
    ratio = rec["useful_flops_ratio"]
    print(f"{arch} {shape}: model_flops {rec['model_flops']:.4e}, counted "
          f"{rec['cost']['ops']:.4e}, ratio {ratio:.4f}")
    assert 0.3 < ratio <= 1.0
    assert rec["chips"] == 256 and rec["roofline"]["t_collective_s"] is None
    # every step runs a kernel but the recurrent families' decode steps
    # (plain torch, as the reference's: K4 and K5 run in their prefills)
    assert bool(rec["cost"]["kernels"]) == (arch == "llama3-8b"
                                            or shape == "train_4k")
    assert launches == [f.launches for f in (
        k1.flash_attention, k1.flash_attention_bwd, k3.decode_attention, k4.ssd,
        k4.ssd_bwd, k5.rglru, k5.rglru_bwd)]

    # per-chip params: the reference's shard shapes at the same mesh
    kind = SHAPES[shape].kind
    dtype = jnp.float32 if kind == "train" else jnp.bfloat16
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs = jax_param_pspecs(jax_get_bundle(arch).param_specs(dtype), mesh)
    shapes = jax_get_bundle(arch).param_specs(dtype)
    if kind != "train":
        from repro.distributed.sharding import strip_dp
        specs = strip_dp(specs)
    want = sum(math.prod(NamedSharding(mesh, sp).shard_shape(sd.shape)) * sd.dtype.itemsize
               for sp, sd in zip(jax.tree_util.tree_leaves(
                   specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
                   jax.tree_util.tree_leaves(shapes)))
    assert rec["memory_per_chip"]["params"] == want
    if kind == "train":
        assert rec["memory_per_chip"]["opt_state"] == 2 * want


def test_failing_cell_is_recorded_and_the_sweep_goes_on(tmp_path, monkeypatch, capsys):
    real = dryrun.count_step

    def flaky(bundle, shape):
        if bundle.arch == "stablelm-3b":
            raise RuntimeError("boom")
        return real(bundle, shape)

    monkeypatch.setattr(dryrun, "count_step", flaky)
    for arch in ("stablelm-3b", "internvl2-1b"):
        dryrun.main(["--arch", arch, "--shape", "decode_32k", "--out", str(tmp_path)])
    bad = json.loads((tmp_path / "stablelm-3b__decode_32k__pod.json").read_text())
    good = json.loads((tmp_path / "internvl2-1b__decode_32k__pod.json").read_text())
    assert bad["status"] == "error" and "boom" in bad["error"]
    assert good["status"] == "ok"
    dryrun.main(["--arch", "internvl2-1b", "--shape", "decode_32k", "--out",
                 str(tmp_path), "--skip-existing"])
    assert "[skip] internvl2-1b decode_32k pod" in capsys.readouterr().out


def test_cells_skip_long_context_for_attention_archs():
    got = list(dryrun.cells(["llama3-8b", "mamba2-1.3b"], list(SHAPES), ["pod"]))
    assert ("llama3-8b", "long_500k", "pod") not in got
    assert ("mamba2-1.3b", "long_500k", "pod") in got
    assert len(got) == 2 * len(SHAPES) - 1


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_meta_branches_count_and_launch_nothing():
    before = [f.launches for f in (k1.flash_attention, k1.flash_attention_bwd,
                                   k2.quantize_int8, k2.dequantize_int8,
                                   k3.decode_attention, k4.ssd, k4.ssd_bwd,
                                   k5.rglru, k5.rglru_bwd)]
    with cost.kernel_tally() as tally:
        q, kk, v = _meta(2, 64, 8, 32), _meta(2, 64, 2, 32), _meta(2, 64, 2, 32)
        o, lse = k1.flash_attention_lse(q, kk, v, window=16)
        assert o.shape == q.shape and lse.shape == (2, 8, 64) and o.is_meta
        grads = k1.flash_attention_bwd(q, kk, v, o, lse, _meta(2, 64, 8, 32), window=16)
        assert [g.shape for g in grads] == [q.shape, kk.shape, v.shape]
        out = k3.decode_attention(_meta(3, 8, 64), _meta(3, 100, 2, 64),
                                  _meta(3, 100, 2, 64), 40)
        assert out.shape == (3, 8, 64)
        x = _meta(2, 96, 4, 16, dtype=torch.float32)
        dt = _meta(2, 96, 4, dtype=torch.float32)
        a = _meta(4, dtype=torch.float32)
        bm = _meta(2, 96, 1, 32, dtype=torch.float32)
        y, st = k4.ssd(x, dt, a, bm, bm, chunk=64, return_state=True)
        assert y.shape == x.shape and st.shape == (2, 4, 32, 16)
        dgrads = k4.ssd_bwd(x, dt, a, bm, bm, _meta(2, 96, 4, 16, dtype=torch.float32),
                            chunk=64)
        assert dgrads[5] is None and dgrads[0].shape == x.shape
        r = k5.rglru(_meta(2, 50, 32, dtype=torch.float32),
                     _meta(2, 50, 32, dtype=torch.float32))
        k5.rglru_bwd(r, r, r)
        qq, sc = k2.quantize_int8(_meta(5, 64))
        assert qq.dtype == torch.int8 and sc.shape == (5, 1)
        k2.dequantize_int8(qq, sc)
    after = [f.launches for f in (k1.flash_attention, k1.flash_attention_bwd,
                                  k2.quantize_int8, k2.dequantize_int8,
                                  k3.decode_attention, k4.ssd, k4.ssd_bwd,
                                  k5.rglru, k5.rglru_bwd)]
    assert before == after
    pairs = cost.attention_pairs(64, True, 16)
    assert tally["flash_attention"] == {
        "calls": 1, "ops": 2.0 * 64 * 2 * 8 * pairs,
        "bytes": float(2 * (2 * 64 * 8 * 32 * 2 + 2 * 2 * 64 * 2 * 32) + 2 * 8 * 64 * 4)}
    assert tally["flash_attention_bwd"]["ops"] == 2.0 * 160 * 2 * 8 * pairs
    assert tally["decode_attention"] == {"calls": 1, "ops": 4.0 * 3 * 8 * 40 * 64,
                                         "bytes": float((2 * 3 * 40 * 2 * 64
                                                         + 2 * 3 * 8 * 64) * 2)}
    assert tally["ssd"]["ops"] == cost.ssd_flops(2, 96, 4, 1, 32, 16, 64, False, True)[0]
    assert tally["ssd_bwd"]["ops"] == cost.ssd_bwd_flops(2, 96, 4, 1, 32, 16, 64)
    assert tally["rglru"]["ops"] == 2.0 * 2 * 50 * 32
    assert tally["rglru_bwd"]["ops"] == 3.0 * 2 * 50 * 32
    assert tally["quantize_int8"]["ops"] == 6.0 * 5 * 64
    assert tally["dequantize_int8"]["ops"] == 2.0 * 5 * 64
    assert all(row["calls"] == 1 for row in tally.values())


@pytest.mark.parametrize("s", [1, 2, 7, 64, 77, 333])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 5, 16, 64, 500])
def test_attention_pairs_counts_the_mask(s, causal, window):
    qp = np.arange(s)[:, None]
    kp = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    assert cost.attention_pairs(s, causal, window) == int(keep.sum())


def test_counts_at_the_shapes_of_perf_md():
    """PERF.md §6's operation counts (GFLOP there rounded): K1 at Llama's
    prefill (2.15), MLA (1.35), Llama's training backward (10.76) and MLA's
    (6.99); K4 at Mamba-2's prefill (1.361 needed) and its float32 training
    forward (2.185); K4's backward at the training shape (9.186, also
    tests/test_torch_ssd_plan.py); K3 at Llama's decode (B=8, cur 576:
    19.01 MB)."""
    assert cost.flash_attention_ops(1, 512, 32, 128, 128) == 2_151_677_952
    assert cost.flash_attention_ops(1, 512, 16, 192, 128) == 1_344_798_720
    assert cost.flash_attention_bwd_ops(2, 512, 32, 128, 128) == 10_758_389_760
    assert cost.flash_attention_bwd_ops(2, 512, 16, 192, 128) == 6_992_953_344
    need, tpu = cost.ssd_flops(1, 512, 64, 1, 128, 64, 256, False, True)
    assert need == 1_361_117_184 and tpu == 4_294_967_296
    assert cost.ssd_flops(2, 512, 64, 1, 128, 64, 256)[0] == 2_185_363_456
    assert cost.ssd_bwd_flops(2, 512, 64, 1, 128, 64, 256) == 9_185_656_832
    assert cost.decode_attention_ops(8, 32, 576, 128) == 75_497_472
    assert cost.decode_attention_bytes(8, 576, 8, 128, 8 * 32 * 128, 2) == 19_005_440
