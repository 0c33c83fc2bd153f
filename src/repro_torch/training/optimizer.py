"""AdamW with a cosine LR schedule, in PyTorch: the port of
``repro/training/optimizer.py``.

Optimizer state matches params leaf for leaf, with m and v in float32
whatever the parameter dtype (the standard mixed-precision recipe, as
in the JAX package; ``torch.optim.AdamW`` would keep them in the
parameter's dtype). The update runs in place, one leaf at a time, and a
large leaf one slab of rows along axis 0 at a time (a stacked
per-layer leaf therefore a layer or less at a time), so its float32
temporaries never hold a whole full-width leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Tuple

import torch

from repro_torch.training import tree

# elements per slab of the update and of global_norm: 2^26 (a float32
# temporary of 256 MiB, one full-width minitron-8b MLP matrix)
SLAB = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def init_adamw(params) -> AdamWState:
    leaves = tree.leaves(params)

    def f32():
        return tree.unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                       for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      m=f32(), v=f32())


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine through ``torch.polar``, whose CPU kernel evaluates
    the C library's ``cosf`` as XLA's CPU backend does (``torch.cos``
    uses a vectorised approximation that differs in the last bit), so
    :func:`lr_at` on the CPU equals the JAX package's bitwise."""
    return torch.polar(torch.ones_like(x), x).real


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps``; float32 arithmetic as in the JAX
    package. ``step``: an integer tensor (or int)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + _cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _slabs(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shape tensors, SLAB elements or fewer (but
    at least one row along axis 0) each."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= SLAB:
        yield ts
        return
    rows = max(1, SLAB // (t.numel() // t.shape[0]))
    yield from zip(*(x.split(rows) for x in ts))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for g in tree.leaves(grads):
        total = total + sum(x.float().square().sum() for (x,) in _slabs(g))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step, with the gradients clipped to global norm
    ``grad_clip``. Updates ``params`` and ``state``'s moments in place
    and returns (params, new state, the pre-clip grad norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()
    flat = (tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
            tree.leaves(state.v))
    for leaf in zip(*flat):
        for p, g, m, v in _slabs(*leaf):
            g = g.float() * scale
            m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g)
            v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * g.square())
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (vhat.sqrt() + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), gnorm
