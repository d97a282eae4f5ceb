"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), bit for bit: every parameter's and
optimizer slot's spec of all ten archs at full size on both production
layouts, the batch and cache specs, and the activation guard.  The
reference runs on abstract meshes (no devices) and ``jax.eval_shape``
(no allocation); the port on device-free meshes and meta tensors."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as RSHAPES
from repro.configs.registry import ARCHS as RARCHS
from repro.models.model import build_model as rbuild_model
from repro.sharding import constraints as RC
from repro.sharding import specs as RSH
from repro.training.optimizer import adafactor as radafactor
from repro.training.optimizer import make_optimizer as rmake_optimizer
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, Mesh,
                                     make_card_mesh, make_map_mesh,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models.model import build_model
from repro_torch.sharding import constraints as C
from repro_torch.sharding import specs as SH
from repro_torch.training.optimizer import adafactor, make_optimizer

LAYOUTS = {"single": ((16, 16), ("data", "model")),
           "multi": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(layout):
    sizes, names = LAYOUTS[layout]
    return AbstractMesh(sizes, names), Mesh(names, sizes)


def _names(path) -> tuple:
    return tuple(str(getattr(p, "key", getattr(p, "name", p)))
                 for p in path)


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    model = rbuild_model(RARCHS[arch])
    return jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,),
                                                           jnp.uint32))


def ref_leaves(tree) -> dict:
    return {_names(p): l for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_spec_tree(shardings) -> dict:
    return {_names(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _norm(spec) -> tuple:
    """A spec with one-axis tuples written as the axis name, as
    ``PartitionSpec`` stores them (``("data",)`` and ``"data"`` shard the
    same way)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _pad(spec, rank) -> tuple:
    return _norm(spec) + (None,) * (rank - len(spec))


def assert_same_specs(port: dict, ref_specs: dict, ref_shapes: dict,
                      prefix=()):
    """``port``: {name: NamedSharding} (port names, layer index in the
    name); ``ref_specs``/``ref_shapes``: {path: spec / shape} of the
    stacked reference.  A per-layer name's spec must be the stacked
    leaf's without its leading None."""
    seen = set()
    for name, sh in port.items():
        parts = tuple(name.split("."))
        path = prefix + tuple(p for p in parts if not p.isdigit())
        stacked = any(p.isdigit() for p in parts)
        ref_shape = tuple(ref_shapes[path].shape)
        ref = _pad(ref_specs[path], len(ref_shape))
        if stacked:
            assert ref[0] is None, (path, ref)
            ref = ref[1:]
            ref_shape = ref_shape[1:]
        got = _pad(sh.spec, len(ref_shape))
        assert got == ref, (name, got, ref)
        seen.add(path)
    assert seen == set(ref_specs), set(ref_specs) ^ seen


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_adamw_specs_match_reference(arch, layout):
    rmesh, mesh = meshes(layout)
    cfg = ARCHS[arch]
    rparams = ref_params(arch)
    params = build_model(cfg).init_shapes()
    shapes = ref_leaves(rparams)
    for infer in (False, True):
        port = SH.params_shardings(params, cfg, mesh, infer=infer)
        ref = ref_spec_tree(RSH.params_shardings(rparams, cfg, rmesh,
                                                 infer=infer))
        assert_same_specs(port, ref, shapes)
    # AdamW's moments: the slot name is stripped before the rule reads
    # the path
    ropt = jax.eval_shape(rmake_optimizer(cfg).init, rparams)
    opt = make_optimizer(cfg).init(params)
    port = SH.params_shardings(opt, cfg, mesh)
    ref = ref_spec_tree(RSH.params_shardings(ropt, cfg, rmesh))
    rshapes = ref_leaves(ropt)
    for slot in ("mu", "nu"):
        assert_same_specs(port[slot],
                          {k[1:]: v for k, v in ref.items()
                           if k[0] == slot},
                          {k[1:]: v for k, v in rshapes.items()
                           if k[0] == slot})


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "zamba2-7b", "whisper-medium"])
def test_adafactor_specs_match_reference(arch):
    """Adafactor's factored slots drop the last dim: the spec is cut to
    the slot's rank, as the reference re-guards it.  The port's state
    keeps the reference's stacked shapes under its path names."""
    rmesh, mesh = meshes("single")
    cfg = ARCHS[arch]
    rparams = ref_params(arch)
    ropt = jax.eval_shape(radafactor().init, rparams)
    opt = adafactor().init(build_model(cfg).init_shapes())
    port = SH.params_shardings(opt, cfg, mesh)
    ref = ref_spec_tree(RSH.params_shardings(ropt, cfg, rmesh))
    rshapes = ref_leaves(ropt)
    n = 0
    for path, slots in port.items():
        for slot, sh in slots.items():
            key = tuple(path.split(".")) + (slot,)
            shape = opt[path][slot].shape
            assert tuple(shape) == tuple(rshapes[key].shape), key
            assert _pad(sh.spec, len(shape)) == _pad(ref[key], len(shape)), \
                (key, sh.spec, ref[key])
            n += 1
    assert n == len(ref)


BATCHES = sorted({s.global_batch for s in RSHAPES.values()} | {1, 3, 48})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_batch_and_cache_specs_match_reference(layout):
    rmesh, mesh = meshes(layout)
    for B in BATCHES:
        for rank in (1, 2, 3):
            assert _norm(SH.batch_spec(mesh, B, rank)) == \
                tuple(RSH.batch_spec(rmesh, B, rank)), (B, rank)
        for arch, cfg in sorted(ARCHS.items()):
            if cfg.family != "ssm":
                assert _norm(SH.attn_cache_spec(cfg, mesh, B)) == tuple(
                    RSH.attn_cache_spec(cfg, rmesh, B)), (arch, B)
            if cfg.ssm_state:
                got = SH.ssm_cache_spec(cfg, mesh, B)
                want = RSH.ssm_cache_spec(cfg, rmesh, B)
                assert _norm(got.state) == tuple(want.state)
                assert _norm(got.conv) == tuple(want.conv)
            got = jax.tree_util.tree_flatten_with_path(
                SH.caches_shardings(cfg, mesh, B),
                is_leaf=lambda x: isinstance(x, SH.NamedSharding))[0]
            want = jax.tree_util.tree_flatten_with_path(
                RSH.caches_shardings(cfg, rmesh, B))[0]
            assert [(_names(p), _norm(s.spec)) for p, s in got] == \
                [(_names(p), tuple(s.spec)) for p, s in want], (arch, B)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shard_shapes_match_reference(layout):
    """A guarded spec's shard shape equals ``NamedSharding.shard_shape``
    of the reference on the same abstract mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rmesh, mesh = meshes(layout)
    cfg = ARCHS["qwen2-moe-a2.7b"]
    for shape in ((60, 2048, 1408), (2048, 151936), (24, 32, 4096, 16, 128),
                  (256, 4097), (7, 5)):
        for axes in ((None, "data", "model"), ("model", None, "data"),
                     (("data", "model"),), ("model",)):
            spec = SH._spec(mesh, shape, *axes)
            assert _norm(spec) == tuple(RSH._spec(rmesh, shape, *axes))
            assert SH.NamedSharding(mesh, spec).shard_shape(shape) == \
                tuple(NamedSharding(rmesh, P(*spec)).shard_shape(shape))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_guard_matches_reference(layout):
    rmesh, mesh = meshes(layout)
    dims = (1, 2, 15, 16, 24, 32, 48, 256, 512, 4096)
    axes = (None, "data", "model", "pod", ("data", "model"),
            ("pod", "data"), ("pod", "data", "model"), "seq")
    with RC.use_mesh(rmesh), C.use_mesh(mesh):
        assert C.get_mesh() is mesh
        assert C.batch_axes() == RC.batch_axes()
        for d in dims:
            for a in axes:
                assert C._guard(d, a) == RC._guard(d, a), (d, a)
    assert C.get_mesh() is None and C.batch_axes() is None


def test_constrain_returns_its_input():
    x = torch.zeros(4, 8)
    tree = {"a": x}
    with C.use_mesh(make_production_mesh()):
        assert C.constrain(x, ("data",), "model") is x
        assert C.constrain_like_params(tree, ARCHS["qwen3-1.7b"]) is tree
    assert C.constrain(x, None, None) is x


def test_meshes_and_card_constants():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 16, "model": 16} and m.size == 256
    mm = make_production_mesh(multi_pod=True)
    assert mm.axis_names == ("pod", "data", "model") and mm.size == 512
    assert make_test_mesh().shape == {"data": 2, "model": 4}
    assert make_map_mesh(4).shape == {"shards": 4}
    assert make_card_mesh().size == 1
    # the H100 SXM5's datasheet figures, none of the TPU's
    assert (PEAK_FLOPS_BF16, HBM_BW, HBM_BYTES, NVLINK_BW) == (
        989e12, 3.35e12, 80e9, 450e9)
