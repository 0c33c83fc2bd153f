"""Partition rules for params, optimizer state, batches and caches, and the
slicing that keeps one rank's part: the port of
``repro/distributed/sharding.py``.

The rules are the reference's, as pure functions of shapes, with the
same names and the same divisibility-guarded fallbacks. Megatron-style
tensor parallelism on the "model" axis:
  * attention q/k/v and MLP up/gate shard their OUTPUT features,
  * attention out and MLP down shard their INPUT features (row-parallel:
    the model sums the partial products, ``ParallelContext.all_reduce_sum``),
  * embeddings shard the vocab dim; lm_head shards vocab (output),
  * MoE expert weights shard the EXPERT dim,
  * the small recurrent cores replicate; the hybrid's shared attention
    block shards like attention.

A spec (:class:`Spec`, a tuple) has one entry a dim: None (replicated),
an axis name, or a tuple of axis names, as ``jax.sharding.PartitionSpec``
reads (a one-name tuple is written as the name, as PartitionSpec
normalizes it). A tree nests dicts, NamedTuples, tuples and lists, as a
JAX pytree does; its leaves have ``.shape`` and ``.ndim``: tensors, numpy
arrays, or shape stand-ins.
:func:`shard_leaf` and :func:`shard_params` keep a rank's slice.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

from repro_torch.distributed.context import ParallelContext



class Spec(tuple):
    """A partition spec: a tuple, told apart from a tree's tuples."""

# Tunable sharding choices (the reference's post-hillclimb defaults):
# "mla_cache": "seq" shards the MLA latent cache's sequence dim over the
# model axis; the baseline "lora" shards the 512-dim latent.
OPTIONS = {"mla_cache": "seq"}


def set_baseline():
    """The paper-faithful / first-cut sharding."""
    OPTIONS["mla_cache"] = "lora"


@contextlib.contextmanager
def sharding_options(**overrides):
    """Scoped override of ``OPTIONS``, restored on exit (on an exception
    too); unknown keys raise KeyError."""
    unknown = set(overrides) - set(OPTIONS)
    if unknown:
        raise KeyError(f"unknown sharding option(s): {sorted(unknown)}; "
                       f"valid: {sorted(OPTIONS)}")
    saved = dict(OPTIONS)
    OPTIONS.update(overrides)
    try:
        yield OPTIONS
    finally:
        OPTIONS.clear()
        OPTIONS.update(saved)


# leaf names whose LAST dim is the sharded output-feature dim
_COL_PARALLEL = {"wq", "wk", "wv", "up", "gate", "wuk", "wuv",
                 "bq", "bk", "bv"}
# leaf names whose SECOND-TO-LAST dim is the sharded input-feature dim
_ROW_PARALLEL = {"wo", "down"}
# MoE expert-stacked weights: dim -3 is the expert dim
_EXPERT = {"w_gate", "w_up", "w_down"}


def P(*parts) -> Spec:
    """A spec, one-name tuples written as the name."""
    return Spec(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                for p in parts)


def _children(tree):
    """(keys, values, rebuild) of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree), list(tree.values()), \
            lambda vs: dict(zip(tree, vs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree), lambda vs: type(tree)(*vs)
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec) \
            and not hasattr(tree, "shape"):
        return list(range(len(tree))), list(tree), \
            lambda vs: type(tree)(vs)
    return None


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(path, tree)
    keys, vals, build = node
    return build([_map_with_path(fn, v, path + (k,))
                  for k, v in zip(keys, vals)])


def _map2(fn, specs, tree):
    """``fn(spec, leaf)`` over two trees of one structure."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(specs, tree)
    keys, vals, build = node
    spec_vals = ([specs[k] for k in keys] if isinstance(specs, dict)
                 else list(specs))
    return build([_map2(fn, s, v) for s, v in zip(spec_vals, vals)])


def _guarded(shape: Sequence[int], candidates, axis_size: int, axes) -> Spec:
    """First candidate dim list whose every sharded dim divides."""
    for dims in candidates:
        if all(shape[d] % axis_size == 0 for d in dims):
            spec = [None] * len(shape)
            for d in dims:
                spec[d] = axes
            return P(*spec)
    return P(*([None] * len(shape)))


def param_spec(path, leaf, mx: str = "model", mx_size: int = 16) -> Spec:
    names = [str(n) for n in path]
    name = names[-1]
    nd = leaf.ndim
    shape = tuple(leaf.shape)
    in_ssm_core = any(n in ("mamba", "core") for n in names)
    in_shared_moe = "shared" in names
    if name == "embed":      # prefer vocab-sharded; fall back to d_model
        return _guarded(shape, [(0,), (1,)], mx_size, mx)
    if name == "lm_head":
        return _guarded(shape, [(1,), (0,)], mx_size, mx)
    if in_shared_moe or in_ssm_core:
        return P(*([None] * nd))
    if name in _EXPERT and "moe" in names:
        return _guarded(shape, [(nd - 3,)], mx_size, mx)
    if name in _COL_PARALLEL and nd >= 1:
        return _guarded(shape, [(nd - 1,)], mx_size, mx)
    if name in _ROW_PARALLEL and nd >= 2:
        return _guarded(shape, [(nd - 2,), (nd - 1,)], mx_size, mx)
    return P(*([None] * nd))


def param_specs(params_shapes: Any, ctx: ParallelContext) -> Any:
    """Tree of specs matching a params (or shape) tree."""
    mx = ctx.model_axis
    mx_size = ctx.mesh.shape[mx]
    return _map_with_path(lambda path, leaf: param_spec(path, leaf, mx,
                                                        mx_size),
                          params_shapes)


def _dp_size(ctx: ParallelContext) -> int:
    n = 1
    for a in ctx.data_axes:
        n *= ctx.mesh.shape[a]
    return n


def opt_specs(opt_shapes: Any, pspecs: Any,
              ctx: Optional[ParallelContext] = None,
              zero1: bool = False) -> Any:
    """AdamW state: m / v follow their param's spec, step replicated.
    ``zero1`` also shards the first still-replicated, divisible dim of
    each m / v leaf over the data axes (ZeRO-1)."""
    from repro_torch.training.optimizer import AdamWState
    m = pspecs
    if zero1 and ctx is not None:
        dpn = _dp_size(ctx)
        dp = tuple(ctx.data_axes)

        def z1(spec, leaf):
            parts = list(spec) + [None] * (leaf.ndim - len(spec))
            for i, s in enumerate(parts):
                if s is None and leaf.shape[i] % dpn == 0:
                    parts[i] = dp
                    return P(*parts)
            return spec
        m = _map2(z1, pspecs, opt_shapes.m)
    return AdamWState(step=P(), m=m, v=m)


def batch_specs(batch_shapes: Any, ctx: ParallelContext) -> Any:
    dp = tuple(ctx.data_axes)
    dpn = _dp_size(ctx)

    def spec(path, leaf):
        if leaf.ndim == 0 or leaf.shape[0] % dpn:
            return P(*([None] * leaf.ndim))
        return P(dp, *([None] * (leaf.ndim - 1)))
    return _map_with_path(spec, batch_shapes)


def logits_spec(ctx: ParallelContext, batch: int, vocab: int) -> Spec:
    dp = tuple(ctx.data_axes)
    b_ok = batch % _dp_size(ctx) == 0
    v_ok = vocab % ctx.mesh.shape[ctx.model_axis] == 0
    return P(dp if b_ok else None, ctx.model_axis if v_ok else None)


def cache_specs(cache_shapes: Any, ctx: ParallelContext, batch: int) -> Any:
    """Decode-cache specs: batch dim -> data axes; head / latent dims ->
    model axis (the sequence dim as fallback when heads don't divide)."""
    dp = tuple(ctx.data_axes)
    mx = ctx.model_axis
    mxn = ctx.mesh.shape[mx]
    dpn = _dp_size(ctx)

    def spec(path, leaf):
        name = str(path[-1])
        nd = leaf.ndim
        s: list = [None] * nd
        shape = tuple(leaf.shape)
        bdim = None
        if batch > 1 and batch % dpn == 0:
            for i, d in enumerate(shape):
                if d == batch:
                    bdim = i
                    break
        if name in ("k_scale", "v_scale"):
            seq_dim, head_dim = nd - 2, nd - 1
            if bdim is not None:
                s[bdim] = dp
            if shape[head_dim] % mxn == 0:
                s[head_dim] = mx
            elif shape[seq_dim] % mxn == 0 and seq_dim != bdim:
                s[seq_dim] = mx
            if bdim is None and s[seq_dim] is None \
                    and shape[seq_dim] % dpn == 0:
                s[seq_dim] = dp
        elif name in ("k", "v", "xk", "xv"):
            seq_dim, head_dim = nd - 3, nd - 2
            if bdim is not None:
                s[bdim] = dp
            if shape[head_dim] % mxn == 0:
                s[head_dim] = mx
            elif shape[seq_dim] % mxn == 0 and seq_dim != bdim:
                s[seq_dim] = mx          # context parallel on the cache
            if bdim is None and s[seq_dim] is None \
                    and shape[seq_dim] % dpn == 0:
                s[seq_dim] = dp          # B=1 long-context: seq over data
        elif name in ("c_kv", "k_r"):
            seq_dim, feat = nd - 2, nd - 1
            if bdim is not None:
                s[bdim] = dp
            if OPTIONS["mla_cache"] == "seq":
                if shape[seq_dim] % mxn == 0 and seq_dim != bdim:
                    s[seq_dim] = mx
                elif bdim is None and shape[seq_dim] % dpn == 0:
                    s[seq_dim] = dp
            else:   # "lora" baseline
                if name == "c_kv" and shape[feat] % mxn == 0:
                    s[feat] = mx
                if bdim is None and shape[seq_dim] % dpn == 0:
                    s[seq_dim] = dp
        else:   # recurrent states: shard batch only
            if bdim is not None:
                s[bdim] = dp
        return P(*s)
    return _map_with_path(spec, cache_shapes)


def serving_cache_specs(cache_shapes: Any, ctx: ParallelContext,
                        paged: bool = False) -> Any:
    """Engine KV-cache specs: the slot / batch dim always replicates (the
    host schedules slots, and every rank holds the same slot state); K/V
    shard the KV-HEAD dim over the model axis, falling back to the
    sequence dim (dense) or the physical-block dim (paged), replicated
    when neither divides.

      dense  kv  (L, B, S, Hkv, hd):     head -> model, else S
      paged  pool (L, P, bs, Hkv, hd):   head -> model, else P
      int8 scales (.., S, Hkv):           head -> model, else seq/P
    """
    mx = ctx.model_axis
    mxn = ctx.mesh.shape[mx]

    def spec(path, leaf):
        name = str(path[-1])
        nd = leaf.ndim
        if name in ("k", "v", "xk", "xv"):
            head_dim = nd - 2
            fallback = 1 if paged else nd - 3
            return _guarded(leaf.shape, [(head_dim,), (fallback,)], mxn, mx)
        if name in ("k_scale", "v_scale"):
            head_dim = nd - 1
            fallback = 1 if paged else nd - 2
            return _guarded(leaf.shape, [(head_dim,), (fallback,)], mxn, mx)
        return P(*([None] * nd))     # recurrent leaves: replicated
    return _map_with_path(spec, cache_shapes)


# -- a rank's slice -------------------------------------------------------------
def _parts(entry, ctx: ParallelContext) -> int:
    n = 1
    for a in ((entry,) if isinstance(entry, str) else entry):
        n *= ctx.mesh.shape[a]
    return n


def shard_leaf(full, spec: Spec, ctx: ParallelContext):
    """This rank's slice of ``full`` (a tensor or numpy array) under
    ``spec``: each sharded dim cut into equal parts along its axes, the
    part at this rank's index along them, as a copy that owns its memory
    (a kept view would hold the whole leaf); a replicated leaf comes back
    as it is."""
    out = full
    for d, s in enumerate(spec):
        if s is None:
            continue
        n = _parts(s, ctx)
        size = full.shape[d] // n
        lo = ctx.axis_index(s) * size
        index = [slice(None)] * full.ndim
        index[d] = slice(lo, lo + size)
        out = out[tuple(index)]
    if out is full:
        return full
    return out.clone() if hasattr(out, "clone") else out.copy()


def shard_params(tree: Any, ctx: ParallelContext) -> Any:
    """Each leaf of a full params tree cut to this rank's slice by
    :func:`param_specs`."""
    return _map2(lambda spec, leaf: shard_leaf(leaf, spec, ctx),
                 param_specs(tree, ctx), tree)


def rank_shard(params: Any, ctx: ParallelContext, vocab: int) -> Any:
    """``params`` as this rank's shard: a full tree (its embedding holds
    all ``vocab`` rows) is cut by :func:`shard_params`; a shard (its
    embedding holds vocab / tp rows) is kept as it is, not copied."""
    if ctx.tp == 1 or params["embed"].shape[0] != vocab:
        return params
    return shard_params(params, ctx)
