"""Training step: loss, grads, AdamW update, remat policy, in PyTorch:
the port of ``repro/training/train_step.py``.

``make_train_step`` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) function. Gradients come from ``torch.autograd.grad``
over the parameter leaves; the update runs in place. Rematerialisation
is passed to ``models.model.forward`` as an argument (the JAX package
sets a module flag for the duration of the call). One device only:
``parallel`` must be None.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import SLICE_TRAIN
from repro_torch.models import model as M
from repro_torch.training import tree
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)

LB_LOSS_COEF = 0.01     # MoE router load-balance coefficient


def cross_entropy(logits, labels) -> torch.Tensor:
    """Mean token CE; label 0 is padding (masked)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    mask = (labels != 0).float()
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1.0)


def _one_device(parallel) -> None:
    if parallel is not None:
        raise NotImplementedError(
            "a parallel context (data / tensor / sequence parallel "
            "training) belongs to sharded training, a later slice of the "
            f"port: parallel must be None (it comes with {SLICE_TRAIN})")


def loss_fn(params, cfg: ModelConfig, batch: Dict, parallel,
            remat, sequence_parallel: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """remat: "layer" (each decoder block checkpointed, the production
    default), True/"full" (the whole forward checkpointed), or
    False/None. ``sequence_parallel`` changes nothing without
    ``parallel``, as in the JAX package."""
    _one_device(parallel)
    logits, lb = M.forward(params, cfg, batch, remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + LB_LOSS_COEF * lb
    return loss, {"ce": ce, "lb_loss": lb}


def value_and_grad(params, cfg: ModelConfig, batch: Dict, parallel=None,
                   remat="layer", sequence_parallel: bool = False):
    """((loss, aux), grads): grads is a tree like ``params`` (each leaf
    in its parameter's dtype). ``params`` need not require grad: the
    forward runs on detached aliases of its leaves."""
    leaves = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree.unflatten(params, live), cfg, batch,
                            parallel, remat, sequence_parallel)
        grads = torch.autograd.grad(loss, live)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    parallel=None, remat="layer", microbatches: int = 1,
                    sequence_parallel: bool = False):
    """``microbatches`` > 1 splits the global batch along axis 0 and
    accumulates the gradients in float32 (activation memory divides by
    the factor; the float32 accumulators add 4 bytes a parameter)."""
    _one_device(parallel)

    def train_step(params, opt_state: AdamWState, batch: Dict):
        def grad_fn(b):
            return value_and_grad(params, cfg, b, parallel, remat,
                                  sequence_parallel)
        if microbatches == 1:
            (loss, metrics), grads = grad_fn(batch)
        else:
            n = batch["tokens"].shape[0]
            if n % microbatches:
                raise ValueError(f"global batch {n} does not split into "
                                 f"{microbatches} microbatches")
            micro = [dict(zip(batch, parts)) for parts in
                     zip(*(v.split(n // microbatches)
                           for v in batch.values()))]
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in tree.leaves(params)]
            l_sum = lb_sum = torch.zeros((), dtype=torch.float32,
                                         device=acc[0].device)
            for mb in micro:
                (l, met), g = grad_fn(mb)
                for a, b in zip(acc, tree.leaves(g)):
                    a.add_(b)           # float32 += the leaf's dtype
                del g, b
                l_sum, lb_sum = l_sum + l, lb_sum + met["lb_loss"]
            for a in acc:
                a.div_(microbatches)
            grads = tree.unflatten(params, acc)
            loss = l_sum / microbatches
            metrics = {"ce": loss, "lb_loss": lb_sum / microbatches}
        params, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=opt_state.step)
        return params, opt_state, metrics
    return train_step
