"""Carry the JAX package's parameters into the port.

``from_jax_numpy`` takes the pytree of ``repro.models.model.init_params``
after ``jax.tree.map(np.asarray, ...)`` (nested dicts of numpy arrays)
and returns the same tree of torch tensors, so both packages run the
same weights. The stacked per-layer leaves stay stacked.
``adamw_from_jax_numpy`` carries the JAX optimizer state across the
same way, so both packages also start from one AdamW state. This module
imports neither JAX nor the JAX package: numpy is the bridge.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.training.optimizer import AdamWState


# leaves the model keeps in f32 whatever its dtype: the MoE router (a
# bf16 router would move routing decisions), Mamba2's decay rates and
# step bias, the mLSTM gates and the sLSTM recurrent weights (the
# recurrent blocks' init_* draw them in f32)
F32_LEAVES = ("router", "a_log", "dt_bias", "wif", "rh")


def from_jax_numpy(tree: Dict[str, Any], device="cuda",
                   dtype: torch.dtype = None, parallel=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``. ``dtype`` casts every leaf but those named in F32_LEAVES
    (None keeps each leaf's floating type; bfloat16 arrays, which numpy
    holds as ml_dtypes, go through float32 exactly). ``parallel``: a
    ``ParallelContext``; each leaf is cut to the rank's slice by
    ``sharding.param_specs`` on the host, before it is moved."""
    if parallel is not None:
        tree = SH.shard_params(tree, parallel)
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device,
                                  None if k in F32_LEAVES else dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def adamw_from_jax_numpy(state, device="cuda"):
    """The JAX package's ``AdamWState`` after ``jax.tree.map(np.asarray,
    ...)`` (step, m, v as numpy) -> the port's
    ``training.optimizer.AdamWState`` on ``device``, so both packages
    start from one optimizer state."""
    return AdamWState(
        step=torch.tensor(int(state.step), dtype=torch.int32, device=device),
        m=from_jax_numpy(state.m, device), v=from_jax_numpy(state.v, device))
