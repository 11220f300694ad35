"""The port's measured-profile calibration against the reference's, on the CPU.

``ModelProfile.unit_scales`` and ``CalibratedCostModel.calibrated`` are
numpy arithmetic copied from the reference: bit for bit equal when both
load the committed ``BENCH_profiles.json`` (read here, never written).  The
float32 torch DP with calibration makes the decisions of the reference's
jitted DP.  ``SegmentProfiler`` cuts the same segments and counts the same
boundary bytes per token as the reference's (times are host measurements
of two different programs and are not compared).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.core import CalibratedCostModel as JaxCalibrated
from repro.core import JaxJointSplitter
from repro.core import SegmentProfile as JaxSegmentProfile
from repro.core import Workload as JaxWorkload
from repro.core.graph import GraphNode as JaxGraphNode
from repro.core.graph import ModelGraph as JaxModelGraph
from repro.edgesim import MECScenarioParams as JaxMEC
from repro.edgesim import base_system_state as jax_base_state
from repro.serving import SegmentProfiler as JaxSegmentProfiler
from repro_torch.configs import get_bundle
from repro_torch.core import (CalibratedCostModel, GraphNode, ModelGraph,
                              ModelProfile, SegmentProfile,
                              SegmentProfileEntry, SystemState,
                              TorchJointSplitter, Workload)
from repro_torch.core.profiling import PROFILE_SCHEMA
from repro_torch.launch import profile_segments
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import SegmentProfiler

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROFILES = ROOT / "BENCH_profiles.json"


def _graph(n, seed, name):
    rng = np.random.default_rng(seed)
    spec = [(f"u{i}", float(rng.uniform(2e10, 6e10)), float(rng.uniform(2e8, 6e8)),
             float(rng.uniform(4e4, 1e5)), i == 0) for i in range(n)]
    return (JaxModelGraph(name, [JaxGraphNode(*u) for u in spec]),
            ModelGraph(name, [GraphNode(*u) for u in spec]))


def _port_state(s):
    return SystemState(s.flops_per_s, s.mem_bytes, s.background_util, s.trusted,
                       s.link_bw, s.link_lat, s.mem_bw, s.names)


@pytest.fixture(scope="module")
def both_models():
    return JaxCalibrated.from_file(PROFILES), CalibratedCostModel.from_file(PROFILES)


def test_committed_profiles_load_the_same(both_models):
    jcm, tcm = both_models
    assert set(tcm.profile.models) == set(jcm.profile.models)
    assert len(tcm.profile.models) >= 3
    for arch, jm in jcm.profile.models.items():
        assert tcm.profile.models[arch].to_doc() == jm.to_doc()


@pytest.mark.parametrize("n_units", [3, 4, 7, 20, 34, 66])
def test_unit_scales_bit_identical(both_models, n_units):
    jcm, tcm = both_models
    for arch, jm in jcm.profile.models.items():
        jf, jx = jm.unit_scales(n_units)
        tf, tx = tcm.profile.models[arch].unit_scales(n_units)
        np.testing.assert_array_equal(tf, jf, err_msg=arch)
        np.testing.assert_array_equal(tx, jx, err_msg=arch)


def test_calibrated_graph_bit_identical(both_models):
    jcm, tcm = both_models
    graphs = [(jax_get_bundle("llama3-8b").model_graph(),
               get_bundle("llama3-8b").model_graph())]
    graphs += [_graph(n, seed, arch)
               for seed, arch in enumerate(jcm.profile.models) for n in (5, 12)]
    for jg, tg in graphs:
        jv, tv = jcm.calibrated(jg), tcm.calibrated(tg)
        assert tv is not tg and tcm.calibrated(tv) is tv
        for field in ("flops", "act_out_bytes", "weight_bytes"):
            np.testing.assert_array_equal(getattr(tv, field), getattr(jv, field),
                                          err_msg=f"{tg.name}.{field}")


def test_empty_profile_is_identity():
    _, tg = _graph(6, 1, "llama3-8b")
    cm = CalibratedCostModel(SegmentProfile())
    assert not cm.profile
    assert cm.calibrated(tg) is tg
    other = CalibratedCostModel.from_file(PROFILES)
    _, unknown = _graph(6, 2, "not-profiled")
    assert other.calibrated(unknown) is unknown


@pytest.mark.parametrize("seed", range(6))
def test_calibrated_splitter_decisions_identical(both_models, seed):
    """The torch DP (CPU) and the reference's jitted DP, each with its own
    package's calibration of the committed profile: same split, same nodes;
    costs agree to float32 rounding."""
    jcm, tcm = both_models
    rng = np.random.default_rng(seed)
    state = jax_base_state(JaxMEC(backhaul_mbps=float(rng.uniform(10, 100))))
    state.background_util[:] = rng.uniform(0.0, 0.8, state.num_nodes)
    wl = (int(rng.integers(16, 512)), int(rng.integers(1, 64)),
          float(rng.uniform(0.5, 4.0)))
    jg = jax_get_bundle("llama3-8b").model_graph()
    tg = get_bundle("llama3-8b").model_graph()
    js = JaxJointSplitter(jcm).solve(jg, state, JaxWorkload(*wl))
    ts = TorchJointSplitter(tcm, device="cpu").solve(tg, _port_state(state),
                                                     Workload(*wl))
    assert ts.boundaries == js.boundaries
    assert ts.assignment == js.assignment
    assert ts.cost == pytest.approx(js.cost, rel=1e-5)
    # and the calibration moved something: the analytic solve prices otherwise
    plain = TorchJointSplitter(device="cpu").solve(tg, _port_state(state),
                                                   Workload(*wl))
    assert plain.cost != ts.cost


def test_profile_store_round_trips_between_packages(tmp_path):
    """The port writes the reference's schema, merge-on-write; each package
    reads what the other wrote."""
    path = tmp_path / "profiles.json"
    entry = SegmentProfileEntry(0, 2, 3e-3, 1e-3, 4100.0, 8192.0)
    mp = ModelProfile("m1", "transformer", 4, 1, 512, True, (entry,))
    SegmentProfile({"m1": mp}).save(path, refreshed=["m1"])
    doc = json.loads(path.read_text())
    assert doc["schema"] == PROFILE_SCHEMA == "bench-profiles/v1"
    back = JaxSegmentProfile.load(path)
    assert back.models["m1"].to_doc() == mp.to_doc()
    JaxSegmentProfile({"m2": back.models["m1"]}).save(path, refreshed=["m2"])
    merged = SegmentProfile.load(path)
    assert set(merged.models) == {"m1", "m2"}
    doc = SegmentProfile({"m1": mp}).save(path, refreshed=["m1"])
    assert set(doc["models"]) == {"m1", "m2"} and doc["refreshed"] == ["m1"]


@pytest.mark.parametrize("compress", [False, True])
def test_segment_profiler_matches_reference_segments_and_bytes(compress):
    jb = jax_get_bundle("llama3-8b", reduced=True)
    jparams = jb.init(jax.random.PRNGKey(0), jnp.float32)
    tb = get_bundle("llama3-8b", reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    jp = JaxSegmentProfiler(jb, batch=2, tokens=16, reps=1, compress=compress,
                            params=jparams).profile()
    prof = SegmentProfiler(tb, tparams, batch=2, tokens=16, reps=1,
                           compress=compress)
    tp = prof.profile()
    assert (tp.arch, tp.family, tp.graph_units, tp.batch, tp.tokens,
            tp.compressed_transfer) == (jp.arch, jp.family, jp.graph_units,
                                        jp.batch, jp.tokens, jp.compressed_transfer)
    assert len(tp.segments) == len(jp.segments) == 3
    for t, j in zip(tp.segments, jp.segments):
        assert (t.lo, t.hi) == (j.lo, j.hi)
        assert t.boundary_bytes_tok == j.boundary_bytes_tok
        assert t.analytic_boundary_bytes_tok == j.analytic_boundary_bytes_tok
        assert t.step_time_s > 0 and t.analytic_time_s > 0
    # the profile's bytes are the transport's own count
    assert prof.transport.stats.transfers == 2
    d = tb.cfg.d_model
    want = d + 4 if compress else 2 * d        # int8 row + its scale, or bf16
    assert [s.boundary_bytes_tok for s in tp.segments] == [want, want, 0.0]
    # Eq. 1 self-calibration: total analytic time equals total measured time
    assert tp.compute_scale == pytest.approx(1.0, rel=1e-9)


def test_profile_segments_writes_only_its_out_file(tmp_path):
    out = tmp_path / "profiles_torch.json"
    before = PROFILES.read_bytes()
    doc = profile_segments.main(["--device", "cpu", "--compress", "--reps", "1",
                                 "--tokens", "8", "--out", str(out)])
    assert out.exists() and PROFILES.read_bytes() == before
    assert set(doc["models"]) == {"llama3-8b"}
    assert doc["source"] == "repro_torch.launch.profile_segments"
    cm = CalibratedCostModel.from_file(out)
    g = get_bundle("llama3-8b").model_graph()
    assert cm.calibrated(g) is not g


def test_profile_segments_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_segments.main(["--out", "unused.json"])
