"""Shared control-plane vocabulary: canonical pool names.

A leaf module so the gateway router, the offline planner, the DES and
the serving runtime can all agree on pool naming without importing
each other.
"""
from __future__ import annotations

from typing import Tuple


def pool_names(k: int) -> Tuple[str, ...]:
    """Canonical pool names for a K-pool fleet.

    K=1 and K=2 keep the paper's "short"/"long" naming (the homogeneous
    baseline is a single worst-case pool, i.e. "long"); K>=3 pools are
    "pool0" (shortest context) .. "pool{K-1}" (longest).
    """
    if k == 1:
        return ("long",)
    if k == 2:
        return ("short", "long")
    return tuple(f"pool{i}" for i in range(k))
