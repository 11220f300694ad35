"""The port's sharding policy against the reference's, on the CPU.

The reference runs on ``jax.sharding.AbstractMesh`` (no devices), the port
on the same mesh shapes: 16×16 and 2×16×16 (the production meshes), 2×2 and
2×2×2.  For every leaf of all eleven full-size configs (the reference's
``param_specs`` are shapes only; the port's are ``meta`` tensors) the
specs of ``param_pspecs``, ``strip_dp``, ``input_pspecs`` and
``cache_pspecs`` at every shape of ``SHAPES`` are identical as
``PartitionSpec``s (jax folds a one-name tuple such as ``("data",)`` into
the name; the port keeps the reference's source entries, which shard
alike), and the port's shard shapes equal ``NamedSharding.shard_shape``.
``activation_spec`` is held against the spec the reference's ``constrain``
passes to ``with_sharding_constraint`` (recorded by a monkeypatch), and
``plan_elastic_mesh`` against the reference's.  Four gloo processes on a
data 2 × model 2 mesh show which block each rank holds under
``placements`` and what ``constrain`` does to a DTensor.
"""

import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.distributed.context as jax_context
from repro.configs import get_bundle as jax_get_bundle
from repro.distributed import plan_elastic_mesh as jax_plan
from repro.distributed.sharding import cache_pspecs as jax_cache_pspecs
from repro.distributed.sharding import input_pspecs as jax_input_pspecs
from repro.distributed.sharding import param_pspecs as jax_param_pspecs
from repro.distributed.sharding import strip_dp as jax_strip_dp
from repro.models.api import SHAPES as JAX_SHAPES
from repro_torch.configs import ALL_ARCHS, get_bundle
from repro_torch.distributed import (activation_mesh, activation_spec,
                                     cache_pspecs, constrain, input_pspecs,
                                     param_pspecs, placements,
                                     plan_elastic_mesh, strip_dp)
from repro_torch.distributed.sharding import local_slices, shard_shape
from repro_torch.models.api import SHAPES

import _torch_dist_workers as workers

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_flat(tree):
    """{path: leaf} of a reference tree (specs or shapes)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, P)):
        out["/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)] = leaf
    return out


def _port_flat(tree, path=()):
    """{path: leaf} of a port tree (dicts and lists; specs are tuples)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_flat(sub, (*path, str(key))).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_flat(sub, (*path, str(i))).items()}
    return {"/".join(path): tree}


def _same_specs(port_specs, jax_specs, port_shapes=None, sizes=None):
    """Spec trees equal path for path, each port spec the same
    PartitionSpec as the reference's; with shapes, the shard shapes too."""
    mine, ref = _port_flat(port_specs), _jax_flat(jax_specs)
    assert mine.keys() == ref.keys()
    shapes = _port_flat(port_shapes) if port_shapes is not None else {}
    mesh = _abstract(sizes) if sizes else None
    for path, spec in mine.items():
        assert isinstance(spec, tuple), path
        assert P(*spec) == ref[path], (path, spec, ref[path])
        if path in shapes:
            shape = tuple(shapes[path].shape)
            assert len(spec) == len(shape), path
            assert shard_shape(shape, spec, sizes) == \
                NamedSharding(mesh, ref[path]).shard_shape(shape), path


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_get_bundle(arch).param_specs(jnp.float32)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return get_bundle(arch).param_specs(torch.float32)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    jspecs = jax_param_pspecs(_jax_params(arch), _abstract(sizes))
    specs = param_pspecs(_port_params(arch), sizes)
    _same_specs(specs, jspecs, _port_params(arch), sizes)
    _same_specs(strip_dp(specs), jax_strip_dp(jspecs), _port_params(arch), sizes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_and_cache_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    jb, tb = jax_get_bundle(arch), get_bundle(arch)
    for name, shape in SHAPES.items():
        ji = jb.input_specs(JAX_SHAPES[name])
        ti = tb.input_specs(shape)
        _same_specs(input_pspecs(ti, sizes, family=tb.family),
                    jax_input_pspecs(ji, _abstract(sizes), family=jb.family),
                    ti, sizes)
        cache_args = (shape.global_batch, shape.seq_len)
        _same_specs(cache_pspecs(tb.cache_spec(*cache_args), sizes, family=tb.family),
                    jax_cache_pspecs(jb.cache_spec(*cache_args), _abstract(sizes),
                                     family=jb.family),
                    tb.cache_spec(*cache_args), sizes)


def test_embed_keeps_the_reference_entries():
    """The reference's source writes the embedding's dp entry as a tuple
    (``P("model", ("data",))``); the port keeps it so, and a tuple entry of
    a single axis shards as the name does."""
    sizes = MESHES["16x16"]
    spec = param_pspecs(_port_params("llama3-8b"), sizes)["embed"]
    assert spec == ("model", ("data",))
    shape = tuple(_port_params("llama3-8b")["embed"].shape)
    assert shard_shape(shape, spec, sizes) == shard_shape(shape, ("model", "data"), sizes)


ACT_CASES = [("hidden", (8, 128, 64)), ("hidden", (8, 1, 64)),
             ("hidden", (3, 128, 64)), ("hidden", (8, 100, 64)),
             ("hidden_full", (8, 128, 64)), ("hidden_full", (6, 1, 32)),
             ("heads", (8, 128, 16, 8)), ("heads", (8, 128, 6, 8)),
             ("heads1", (8, 16, 8)), ("heads1", (8, 7, 8)),
             ("ff", (8, 128, 256)), ("ff", (8, 128, 100)), ("ff", (4, 256))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_spec_matches_reference_constrain(mesh, monkeypatch):
    sizes = MESHES[mesh]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sh: seen.append(sh.spec) or x)
    monkeypatch.delenv("REPRO_NO_CONSTRAIN", raising=False)
    with jax_context.activation_mesh(_abstract(sizes)):
        for kind, shape in ACT_CASES:
            jax_context.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
    assert len(seen) == len(ACT_CASES)
    for (kind, shape), ref in zip(ACT_CASES, seen):
        spec = activation_spec(shape, kind, sizes)
        assert P(*spec) == ref, (kind, shape, spec, ref)
    with pytest.raises(ValueError):
        activation_spec((8, 16), "nope", sizes)


def test_constrain_passes_plain_tensors_and_no_mesh(monkeypatch):
    x = torch.ones(8, 16, 4)
    assert constrain(x, "hidden") is x                     # no mesh set
    with activation_mesh(MESHES["2x2"]):
        assert constrain(x, "hidden") is x                 # not a DTensor
        monkeypatch.setenv("REPRO_NO_CONSTRAIN", "1")
        assert constrain(x, "ff") is x


@pytest.mark.parametrize("alive,model,pods", [
    (512, 16, 2), (320, 16, None), (256, 16, None), (300, 16, 2), (48, 16, 4),
    (16, 16, None), (4096, 8, 4), (100, 4, 3)])
def test_plan_elastic_mesh_matches_reference(alive, model, pods):
    assert plan_elastic_mesh(alive, model_axis=model, pods=pods) == \
        jax_plan(alive, model_axis=model, pods=pods)


def test_plan_elastic_mesh_fault_tolerance_cases():
    """tests/test_fault_tolerance.py's cases."""
    plan = plan_elastic_mesh(512, model_axis=16, pods=2)
    assert plan["shape"] == {"pod": 2, "data": 16, "model": 16}
    plan = plan_elastic_mesh(320, model_axis=16)
    assert plan["shape"] == {"data": 16, "model": 16}
    assert plan["devices_used"] == 256
    with pytest.raises(RuntimeError):
        plan_elastic_mesh(8, model_axis=16)


PLACE_SPECS = [(("model", "data"), None), (("data", "model"), None),
               ("model", ("data",)), (None, "model"), ("data", None)]
PLACE_ACTS = [("hidden", (4, 8, 6)), ("hidden", (4, 1, 6)),
              ("heads", (4, 8, 4, 3)), ("ff", (4, 8, 10)), ("heads1", (2, 4, 3))]


def test_placements_on_four_processes(tmp_path):
    """Each rank's block under ``placements`` is ``local_slices``' block
    (DTensor's order: a dim's axes in mesh order, data major), its shape the
    reference's shard shape; under ``("model", "data")`` the reference's
    device at (data 1, model 0) holds block 1 (its spec's order: model
    major) where the port's rank holds block 2, as ``sharding.py`` states.
    ``constrain`` redistributes a replicated DTensor to
    ``activation_spec``'s placements and passes a plain tensor through."""
    shape = (8, 6)
    ranks = workers.run(workers.placements_case, 4, tmp_path, PLACE_SPECS, shape,
                        PLACE_ACTS)
    sizes = MESHES["2x2"]
    x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    seen = set()
    for out in ranks:
        coord = out["coord"]
        seen.add((coord["data"], coord["model"]))
        for spec, block in zip(PLACE_SPECS, out["blocks"]):
            assert torch.equal(block, x[local_slices(shape, spec, sizes, coord)])
            assert tuple(block.shape) == NamedSharding(
                _abstract(sizes), P(*spec)).shard_shape(shape)
        if (coord["data"], coord["model"]) == (1, 0):
            rows = local_slices(shape, PLACE_SPECS[0], sizes, coord)[0]
            assert (rows.start, rows.stop) == (4, 6)    # block 2 of 2-row blocks
            assert coord["model"] * 2 + coord["data"] == 1    # the reference's
        for (kind, a_shape), (got, local) in zip(PLACE_ACTS, out["acts"]):
            spec = activation_spec(a_shape, kind, sizes)
            assert got == placements(spec, sizes), (kind, a_shape)
            assert local == shard_shape(a_shape, spec, sizes), (kind, a_shape)
        assert out["plain_unchanged"]
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
