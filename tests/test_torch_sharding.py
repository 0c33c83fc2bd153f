"""The port's partition rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``): for every config of
``configs/`` and model-axis sizes 2, 4, 8 and 16 (a data axis of 2), each
spec function gives the reference's spec leaf by leaf on the same tree
paths. Specs are pure functions of shapes, so both run on an abstract
mesh (``FakeMesh``, as tests/test_sharding.py) and on shapes alone: the
reference's ``jax.eval_shape`` trees, fed to both packages' functions,
and the port's own parameter shapes from ``init_params`` on the meta
device (held equal to the reference's first). One parametrised test per
function, so every case counts.
"""
import functools
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs.base import INPUT_SHAPES, get_config, list_configs
from repro.distributed import sharding as RSH
from repro.distributed.context import ParallelContext as RContext
from repro.launch import input_specs as IS
from repro.models import model as RM
from repro_torch.configs import base as TB
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import ParallelContext
from repro_torch.models import model as TM

ARCHS = list_configs()
MODEL_SIZES = (2, 4, 8, 16)
DATA = 2


def _mesh(model: int):
    return types.SimpleNamespace(shape={"data": DATA, "model": model},
                                 axis_names=("data", "model"))


def _ctxs(model: int):
    """(reference context, port context) on one abstract mesh."""
    mesh = _mesh(model)
    return (RContext(mesh=mesh, data_axes=("data",)),
            ParallelContext(mesh=mesh, data_axes=("data",)))


def _ref_flat(specs):
    """{path of key names: spec as a tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_path(path): tuple(spec) for path, spec in flat}


def _path(path):
    return tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))
                 for k in path)


def _port_flat(tree, path=()):
    """{path: leaf} of a port tree (dicts, NamedTuples, tuples and lists
    around spec or tensor leaves)."""
    node = SH._children(tree)
    if node is None:
        return {path: tree}
    out = {}
    for k, v in zip(*node[:2]):
        out.update(_port_flat(v, path + (k,)))
    return out


def _same(port, ref):
    got, want = _port_flat(port), _ref_flat(ref)
    assert got.keys() == want.keys()
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad
    return len(want)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return IS.abstract_params(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's parameter shapes: init_params on the meta device."""
    return TM.init_params(TB.get_config(arch), device="meta")


def _paged_archs():
    out = []
    for a in ARCHS:
        c = get_config(a)
        if c.family in ("dense", "moe") and c.mla is None \
                and not c.attention_window and not c.kv_cache_dtype:
            out.append(a)
    return out


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, model):
    ref_shapes, port_shapes = _ref_params(arch), _port_params(arch)
    got = {p: tuple(t.shape) for p, t in _port_flat(port_shapes).items()}
    want = {_path(path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(
                ref_shapes)[0]}
    assert got == want
    rctx, tctx = _ctxs(model)
    n = _same(SH.param_specs(port_shapes, tctx),
              RSH.param_specs(ref_shapes, rctx))
    assert n == len(want)


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cache_specs_dense_equal_reference(arch, model):
    cfg = get_config(arch)
    cache = jax.eval_shape(lambda: RM.init_cache(
        cfg, 4, 256, frontend_len=cfg.frontend_tokens or None))
    rctx, tctx = _ctxs(model)
    _same(SH.serving_cache_specs(cache, tctx),
          RSH.serving_cache_specs(cache, rctx))


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", _paged_archs())
def test_serving_cache_specs_paged_equal_reference(arch, model):
    cache = jax.eval_shape(lambda: RM.init_paged_cache(get_config(arch), 64,
                                                       16))
    rctx, tctx = _ctxs(model)
    _same(SH.serving_cache_specs(cache, tctx, paged=True),
          RSH.serving_cache_specs(cache, rctx, paged=True))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, model, shape):
    sh = INPUT_SHAPES[shape]
    cfg = IS.effective_config(get_config(arch), sh)
    _, cache, _ = IS.decode_structs(cfg, sh)
    rctx, tctx = _ctxs(model)
    for opt in ("seq", "lora"):
        with RSH.sharding_options(mla_cache=opt), \
                SH.sharding_options(mla_cache=opt):
            _same(SH.cache_specs(cache, tctx, sh.global_batch),
                  RSH.cache_specs(cache, rctx, sh.global_batch))


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, model):
    cfg = get_config(arch)
    rctx, tctx = _ctxs(model)
    for name in ("train_4k", "prefill_32k", "long_500k"):
        sh = INPUT_SHAPES[name]
        batch = IS.batch_struct(cfg, sh, train=sh.kind == "train")
        _same(SH.batch_specs(batch, tctx), RSH.batch_specs(batch, rctx))


@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_spec_equal_reference(arch, model):
    vocab = get_config(arch).vocab_size
    rctx, tctx = _ctxs(model)
    for batch in (1, 2, 3, 8, 128):
        assert SH.logits_spec(tctx, batch, vocab) \
            == tuple(RSH.logits_spec(rctx, batch, vocab))


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_reference(arch, model, zero1):
    ref_shapes = _ref_params(arch)
    opt = IS.abstract_opt(get_config(arch), ref_shapes)
    rctx, tctx = _ctxs(model)
    _same(SH.opt_specs(opt, SH.param_specs(ref_shapes, tctx), tctx,
                       zero1=zero1),
          RSH.opt_specs(opt, RSH.param_specs(ref_shapes, rctx), rctx,
                        zero1=zero1))


@pytest.mark.parametrize("case", ["restore", "exception", "unknown"])
def test_sharding_options_scoped(case):
    """``sharding_options`` restores OPTIONS on exit and on an exception,
    and refuses an unknown key with KeyError, as the reference's does;
    ``set_baseline`` flips the MLA cache rule as the reference's."""
    baseline = dict(SH.OPTIONS)
    assert baseline == RSH.OPTIONS
    other = "lora" if baseline["mla_cache"] == "seq" else "seq"
    if case == "restore":
        with SH.sharding_options(mla_cache=other) as opts:
            assert opts["mla_cache"] == SH.OPTIONS["mla_cache"] == other
        try:
            SH.set_baseline()
            assert SH.OPTIONS["mla_cache"] == "lora"
        finally:
            SH.OPTIONS.update(baseline)
    elif case == "exception":
        with pytest.raises(RuntimeError):
            with SH.sharding_options(mla_cache=other):
                raise RuntimeError("boom")
    else:
        with pytest.raises(KeyError, match="unknown sharding option"):
            with SH.sharding_options(not_an_option=1):
                pass
    assert SH.OPTIONS == baseline


@pytest.mark.parametrize("spec", [(None, "model", None),
                                  ("data", "model", None),
                                  (("data", "model"), None, None),
                                  (None, None, None)])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_leaf_keeps_the_ranks_slice(model, spec):
    """``shard_leaf`` cuts each sharded dim into equal parts and keeps
    the part at the rank's index along the spec's axes (row-major for a
    tuple of axes), as a copy; over the mesh's ranks the slices cover
    every element equally often (once per rank that holds a copy)."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(np.arange(DATA * model).reshape(DATA, model),
                ("data", "model"))
    full = np.arange(8 * 16 * 4).reshape(8, 16, 4)
    cover = np.zeros(full.shape, int)
    n_parts = 1
    for r in mesh.ranks:
        ctx = ParallelContext(mesh=mesh, rank=r)
        got = SH.shard_leaf(full, spec, ctx)
        idx = [slice(None)] * 3
        n_parts = 1
        for d, e in enumerate(spec):
            if e is not None:
                n = SH._parts(e, ctx)
                n_parts *= n
                size = full.shape[d] // n
                idx[d] = slice(ctx.axis_index(e) * size,
                               (ctx.axis_index(e) + 1) * size)
        assert np.array_equal(got, full[tuple(idx)])
        assert got is full if n_parts == 1 else got.base is None
        cover[tuple(idx)] += 1
    assert (cover == mesh.size // n_parts).all()


@pytest.mark.parametrize("model", MODEL_SIZES)
def test_context_axes_equal_reference(model):
    """``data_axes`` / ``model_axis`` / ``all_axes`` / ``ep_size`` read the
    mesh as the reference's context does."""
    rctx, tctx = _ctxs(model)
    assert (tctx.data_axes, tctx.model_axis, tctx.all_axes, tctx.ep_size,
            tctx.tp) == (rctx.data_axes, rctx.model_axis, rctx.all_axes,
                         rctx.ep_size, model)


@pytest.mark.parametrize("case", ["production", "multi_pod", "smoke",
                                  "smoke_error", "submeshes",
                                  "submesh_error"])
def test_launch_meshes(case):
    """``launch/mesh.py``: the production meshes' shapes and axes (a
    description: no process group is made), the smoke mesh over a world
    of ranks and the reference's refusal of a model axis that does not
    divide it, consecutive (1, tp) submeshes and their refusal."""
    from repro_torch.launch import mesh as TMesh
    if case == "production":
        m = TMesh.make_production_mesh()
        assert (m.shape, m.axis_names) == ({"data": 16, "model": 16},
                                           ("data", "model"))
    elif case == "multi_pod":
        m = TMesh.make_production_mesh(multi_pod=True)
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
        assert m.ranks == list(range(512))
    elif case == "smoke":
        m = TMesh.make_smoke_mesh(2, world=8)
        assert m.shape == {"data": 4, "model": 2}
        assert m.coords(5) == {"data": 2, "model": 1}
    elif case == "smoke_error":
        with pytest.raises(ValueError, match="does not divide"):
            TMesh.make_smoke_mesh(3, world=4)
    elif case == "submeshes":
        subs = TMesh.make_submeshes(TMesh.make_smoke_mesh(world=8), 4)
        assert [s.ranks for s in subs] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert all(s.shape == {"data": 1, "model": 4} for s in subs)
    else:
        with pytest.raises(ValueError, match="does not divide"):
            TMesh.make_submeshes(TMesh.make_smoke_mesh(world=6), 4)
