"""The port's examples (``repro_torch.examples``) beside the reference's, on
the CPU.

``quickstart`` and ``serve_batched``: the reference's example scripts run
as they are (``runpy``), the port's ``main(device="cpu")`` on the same
weights (``params_from_jax``): the split, the decision and its reasons
identical, the split's logits within the bf16 rule of
tests/test_torch_model.py; the batcher's stats identical and its tokens
by tests/test_torch_decode.py's margin rule.  ``edge_orchestration``: the reference example's steps
at reduced durations beside the port's ``main`` at the same sizes (two
bandwidths, 30 s runs, a 50 s drill): every KPI within 1e-9 (relative),
the drill's assignment, boundaries and reconfigurations identical.
``train_quickstart``: 3 steps of the recipe from the reference's init,
the reference's loss and AdamW outside a mesh (its own example needs a
mesh that jax 0.9 refuses, ROADMAP.md), float32 activations on both
sides, on the reference's weights with unit-variance attention scores
(at the reference's own init the model is chaotic): losses within 1e-5
(relative).
"""

import dataclasses
import functools
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.edgesim as RE
from repro.configs import get_bundle as jax_get_bundle
from repro.core import DecisionKind as JaxDecisionKind
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import transformer as jax_transformer
from repro.models.api import bundle_for as jax_bundle_for
from repro.serving import WaveBatcher as JaxWaveBatcher
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import adamw_init, adamw_update
from repro_torch.configs import get_bundle
from repro_torch.examples import edge_orchestration, quickstart, serve_batched
from repro_torch.examples import train_quickstart
from repro_torch.models import transformer as port_transformer
from repro_torch.models.convert import params_from_jax

from test_torch_decode import MARGIN_TOL
from test_torch_model import _assert_bf16_close

ROOT = Path(__file__).resolve().parents[1]
TRAIN_TOL = 1e-5


def _reference_example(name):
    """The reference's example script run as it is; its globals."""
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"))


def _port_params(ref_params, bundle):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                           bundle.cfg, device="cpu")


def test_quickstart_matches_reference_example():
    ref = _reference_example("quickstart")
    bundle = get_bundle("llama3-8b", reduced=True)
    facts = quickstart.main("cpu", bundle, _port_params(ref["params"], bundle))
    for mine, theirs in ((facts["initial"], ref["cfg"]),
                         (facts["config"], ref["orch"].current)):
        assert (mine.boundaries, mine.assignment) == \
            (theirs.boundaries, theirs.assignment)
    assert facts["decision"].kind.value == ref["decision"].kind.value
    assert list(facts["decision"].reasons) == list(ref["decision"].reasons)
    assert facts["err"] < 1e-3 and ref["err"] < 1e-3
    _assert_bf16_close(facts["logits"].numpy(), np.asarray(ref["split_logits"]))


def test_serve_batched_matches_reference_example(monkeypatch):
    """Equal stats; equal tokens but where the reference's own top-2 margin
    at that step is under tests/test_torch_decode.py's MARGIN_TOL (bf16
    logits), after which a request's tokens follow another history."""
    calls = []                       # the reference's logits, in call order
    init = JaxWaveBatcher.__init__

    def recorded(fn, kind):
        def run(*args):
            logits, cache = fn(*args)
            calls.append((kind, np.asarray(logits, np.float32)))
            return logits, cache
        return run

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        self._prefill = recorded(self._prefill, "prefill")
        self._decode = recorded(self._decode, "decode")

    monkeypatch.setattr(JaxWaveBatcher, "__init__", recording_init)
    ref = _reference_example("serve_batched")
    bundle = get_bundle("llama3-8b", reduced=True)
    facts = serve_batched.main("cpu", bundle, _port_params(ref["params"], bundle))
    assert vars(facts["stats"]) == vars(ref["stats"])
    assert [(r.rid, list(r.prompt)) for r in facts["requests"]] == \
        [(r.rid, list(r.prompt)) for r in ref["reqs"]]
    waves = []                       # per wave: the logits of each step
    for kind, logits in calls:
        if kind == "prefill":
            waves.append([])
        waves[-1].append(logits)
    assert len(waves) == ref["stats"].waves
    for r_i, (jr, tr) in enumerate(zip(ref["reqs"], facts["requests"])):
        assert tr.done and len(tr.output) == len(jr.output)
        w, row = divmod(r_i, ref["batcher"].max_batch)
        for step, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a == b:
                continue
            top = np.sort(waves[w][step][row])
            margin = top[-1] - top[-2]
            assert margin < MARGIN_TOL * np.abs(top).max(), (r_i, step, margin)
            break


EDGE = dict(bandwidths=(20, 200), duration_s=30.0, window=(10.0, 30.0),
            drill_duration_s=50.0, fail_at=30.0)


def _reference_edge(bandwidths, duration_s, window, drill_duration_s, fail_at):
    """examples/edge_orchestration.py's steps at the given sizes."""
    table = {}
    for bw in bandwidths:
        table[bw] = {
            ("adaptive" if adaptive else "static"): RE.build_mec_scenario(
                RE.MECScenarioParams(backhaul_mbps=bw, duration_s=duration_s),
                adaptive=adaptive).run().kpis(*window)
            for adaptive in (False, True)}
    sim = RE.build_mec_scenario(
        RE.MECScenarioParams(backhaul_mbps=50.0, duration_s=drill_duration_s),
        adaptive=True)
    orig = sim.util_traces[1]
    sim.util_traces[1] = type(orig)(
        lambda t: 0.99 if t >= fail_at else orig(t), 0.0, 0.99)
    res = sim.run()
    kinds = [d.kind.value for d in sim.orch.decisions if d.kind in
             (JaxDecisionKind.MIGRATE, JaxDecisionKind.RESPLIT)]
    return {"table": table,
            "uses_node1_before": any(1 in d.config.assignment for d in
                                     sim.orch.decisions[:int(fail_at) - 5]
                                     if d.config),
            "final_assignment": sim.orch.current.assignment,
            "final_boundaries": sim.orch.current.boundaries,
            "reconfigurations": kinds,
            "latency_pre_ms": float(np.mean([m.latency_s for m in res.window(
                fail_at - 10, fail_at)]) * 1e3),
            "latency_post_ms": float(np.mean([m.latency_s for m in res.window(
                drill_duration_s - 20, drill_duration_s)]) * 1e3)}


def test_edge_orchestration_matches_reference_steps():
    ref = _reference_edge(**EDGE)
    facts = edge_orchestration.main("cpu", **EDGE)
    for key in ("uses_node1_before", "final_assignment", "final_boundaries",
                "reconfigurations"):
        assert facts[key] == ref[key], key
    assert facts["reconfigurations"], "the drill reconfigured nothing"
    for key in ("latency_pre_ms", "latency_post_ms"):
        assert facts[key] == pytest.approx(ref[key], rel=1e-9)
    assert facts["table"].keys() == ref["table"].keys()
    for bw, row in ref["table"].items():
        for arm, kpis in row.items():
            mine = facts["table"][bw][arm]
            assert mine.keys() == kpis.keys()
            for k, v in kpis.items():
                assert mine[k] == pytest.approx(v, rel=1e-9, abs=1e-12), (bw, arm, k)


@pytest.fixture
def _f32_both(monkeypatch):
    monkeypatch.setattr(jax_transformer, "embed_tokens", functools.partial(
        jax_transformer.embed_tokens, compute_dtype=jnp.float32))
    monkeypatch.setattr(port_transformer, "embed_tokens", functools.partial(
        port_transformer.embed_tokens, compute_dtype=torch.float32))


@pytest.fixture
def _one_process_group():
    had = dist.is_initialized()
    yield
    if dist.is_initialized() and not had:
        dist.destroy_process_group()


def _conditioned(jparams, cfg):
    """The reference's params with wq and wk scaled by sqrt(H/d) and
    sqrt(KV/d): unit-variance attention scores (chip_smoke.py's
    ``conditioned``); every other leaf is the reference's own."""
    attn = dict(jparams["blocks"]["attn"])
    attn["wq"] = attn["wq"] * (cfg.n_heads / cfg.d_model) ** 0.5
    attn["wk"] = attn["wk"] * (cfg.n_kv / cfg.d_model) ** 0.5
    return {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}


@pytest.mark.usefixtures("_f32_both", "_one_process_group")
def test_train_quickstart_matches_reference_recipe():
    """On the reference's init llama-100m is chaotic (train_curve.py: its
    scores have a std of ~sqrt(d) and every attention is near an argmax, so
    float32 rounding moves even the step-0 loss by ~1e-4 relative); the
    recipe is held on the same weights with unit-variance scores."""
    steps = 3
    r = train_quickstart.RECIPE
    ref = jax_bundle_for(train_quickstart.CONFIG["name"], dataclasses.replace(
        jax_get_bundle("llama3-8b", reduced=True).cfg, **train_quickstart.CONFIG))
    jopt = JaxAdamWConfig(lr=r["lr"], warmup_steps=r["warmup"],
                          total_steps=r["steps"])
    jparams = _conditioned(ref.init(jax.random.PRNGKey(0), jnp.float32), ref.cfg)
    start = _port_params(jparams, train_quickstart.quickstart_bundle())

    @jax.jit
    def jstep(params, st, batch):
        loss, grads = jax.value_and_grad(ref.loss)(params, batch)
        params, st, _ = adamw_update(jopt, params, grads, st)
        return params, st, loss

    data = JaxSyntheticTokens(JaxDataConfig(vocab=ref.cfg.vocab, batch=r["batch"],
                                            seq_len=r["seq"]))
    jstate, want = adamw_init(jparams), []
    for i in range(steps):
        jparams, jstate, loss = jstep(jparams, jstate, jax.tree_util.tree_map(
            jnp.asarray, data.batch_at(i)))
        want.append(float(loss))
    facts = train_quickstart.main("cpu", steps=steps, params=start)
    assert facts["world"] == 1 and facts["fall"] is None
    assert len(facts["times_ms"]) == steps
    print(f"losses port {facts['losses']} reference {want}")
    np.testing.assert_allclose(facts["losses"], want, rtol=TRAIN_TOL)
