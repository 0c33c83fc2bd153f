"""Carry the JAX package's parameters into the port.

``from_jax_numpy`` takes the pytree of ``repro.models.model.init_params``
after ``jax.tree.map(np.asarray, ...)`` (nested dicts of numpy arrays)
and returns the same tree of torch tensors, so both packages run the
same weights. The stacked per-layer leaves stay stacked. This module
imports neither JAX nor the JAX package: numpy is the bridge.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_jax_numpy(tree: Dict[str, Any], device="cuda",
                   dtype: torch.dtype = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``. ``dtype`` casts every leaf (None keeps each leaf's
    floating type; bfloat16 arrays, which numpy holds as ml_dtypes, go
    through float32 exactly)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)
