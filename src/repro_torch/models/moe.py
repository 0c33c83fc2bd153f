"""Mixture-of-Experts block on one device, in PyTorch: the port of
``repro/models/moe.py`` without a mesh (``moe_block`` at ``ep = 1``).

Routing is top-k over the router's f32 softmax with capacity drops, in
the reference's order of operations, so the same pairs are dropped:

* the router logits are ``tokens.float() @ router`` (the router leaf is
  f32); the top k comes from a stable descending sort, so a tie goes to
  the lower expert index, as ``jax.lax.top_k`` breaks it;
* the (token, choice) pairs fill a send buffer of ``cap = max(ceil(T *
  k * cf), 8)`` rows in pair order, and pairs past it are dropped (with
  one shard, the reference's stable argsort by destination shard is the
  identity);
* each expert takes at most ``ecap = max(ceil(cap / E * cf), 8)`` of the
  buffer's rows, in buffer order (a stable argsort by expert, ranks from
  the cumulative counts); the rest are dropped. Dropped rows are written
  to a scratch column that is sliced off, so duplicate writes land only
  there;
* the expert MLPs are batched matmuls over the (E, ecap, D) buffer, the
  gated outputs are added to their tokens choice by choice (the k
  choices of a token in order, each add rounded in the model dtype: the
  reference's scatter-add on the CPU, bit for bit; on the card
  ``index_add_`` adds with atomics in no set order, and a bf16 top-k
  model then gives other bits from run to run), and the shared expert's
  MLP of every token is added last.

A dropped pair contributes nothing: its token's residual passes. Every
expert's buffer holds at least 8 rows, so a call reads every expert's
weights however few tokens it routes. No host sync: ``cap`` and
``ecap`` follow from the shapes. The expert-parallel forms
(``moe_block_sharded``, ``moe_block_psum``) belong to the expert-parallel
slice of the port (``distributed/context.SLICE_EP``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int, dtype,
             device) -> Params:
    """The MoE leaves of ``n`` stacked layers with the reference's
    distributions: the router (n, D, E) in f32 at N(0, 1/D); ``w_gate``
    and ``w_up`` (n, E, D, F) at N(0, 1/D); ``w_down`` (n, E, F, D) at
    N(0, 0.25/D) (the reference scales it by the model width, not by its
    input width F); the shared experts, one gated MLP of F x
    ``num_shared_experts``, as ``init_mlp`` draws it. Drawn in f32 one
    (D, F) slab at a time (``layers.dense_init``)."""
    mc = cfg.moe
    d, e = cfg.d_model, mc.num_experts
    f = mc.expert_d_ff or cfg.d_ff
    p = {"router": L.dense_init(gen, (n, d, e), torch.float32, device),
         "w_gate": L.dense_init(gen, (n, e, d, f), dtype, device),
         "w_up": L.dense_init(gen, (n, e, d, f), dtype, device),
         "w_down": L.dense_init(gen, (n, e, f, d), dtype, device,
                                scale=0.5 * math.sqrt(f / d))}
    if mc.num_shared_experts:
        fs = f * mc.num_shared_experts
        p["shared"] = {"up": L.dense_init(gen, (n, d, fs), dtype, device),
                       "gate": L.dense_init(gen, (n, d, fs), dtype, device),
                       "down": L.dense_init(gen, (n, fs, d), dtype, device)}
    return p


def capacities(cfg: ModelConfig, t: int) -> Tuple[int, int]:
    """(cap, ecap) of a call on ``t`` tokens: the send buffer's rows and
    each expert's, sized as the reference sizes them at ep = 1."""
    mc = cfg.moe
    cap = max(math.ceil(t * mc.top_k * mc.capacity_factor), 8)
    ecap = max(math.ceil(cap / mc.num_experts * mc.capacity_factor), 8)
    return cap, ecap


def moe_block(p: Params, cfg: ModelConfig, x) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D). Returns (y (B, S, D), aux): aux["lb_loss"] is the
    load-balance loss E * sum_e f_e * P_e (0-d f32), aux["router_fraction"]
    f_e, the share of pairs routed to each expert (E,) f32, and
    aux["dropped"] a (B*S*k,) bool mask of the pairs dropped by either
    capacity stage, in (token, choice) order."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    y, aux = _moe_tokens(p, cfg, tokens)
    if "shared" in p:
        y = y + L.mlp(p["shared"], cfg, tokens)
    return y.reshape(b, s, d), aux


def route(router, cfg: ModelConfig, tokens):
    """(probs (T, E) f32, gate (T, k) f32 renormalised, eidx (T, k)
    int64): the top k by a stable descending sort (ties to the lower
    expert)."""
    k = cfg.moe.top_k
    probs = torch.softmax(tokens.float() @ router, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :k], eidx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _moe_tokens(p: Params, cfg: ModelConfig, tokens):
    mc = cfg.moe
    t, d = tokens.shape
    e, k = mc.num_experts, mc.top_k
    # ---- routing --------------------------------------------------------
    probs, gate, eidx = route(p["router"], cfg, tokens)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    flat_e = eidx.reshape(-1)                                   # (T*k,)
    fe = _counts(flat_e, e).float() / (t * k)
    lb_loss = e * torch.sum(fe * probs.mean(0))
    # ---- the send buffer: the first cap pairs in (token, choice) order --
    n_pairs = t * k
    flat_g = gate.reshape(-1).to(tokens.dtype)
    flat_tok = torch.arange(t, device=tokens.device).repeat_interleave(k)
    cap, ecap = capacities(cfg, t)
    n_send = min(n_pairs, cap)
    r_tok = tokens.new_zeros((cap, d))
    r_tok[:n_send] = tokens[flat_tok[:n_send]]
    r_eid = torch.full((cap,), e, dtype=torch.long, device=tokens.device)
    r_eid[:n_send] = flat_e[:n_send]                           # e = empty
    # ---- the experts, capacity-bucketed --------------------------------
    y_recv, ok = _expert_apply(r_tok, r_eid, p, e, ecap)
    pair_out = tokens.new_zeros((n_pairs, d))
    pair_out[:n_send] = y_recv[:n_send]
    gated = (pair_out * flat_g[:, None]).view(t, k, d)
    y = tokens.new_zeros((t, d))
    for c in range(k):
        y = y + gated[:, c]
    dropped = torch.ones(n_pairs, dtype=torch.bool, device=tokens.device)
    dropped[:n_send] = ~ok[:n_send]
    return y, {"lb_loss": lb_loss, "router_fraction": fe, "dropped": dropped}


def _counts(idx, n: int):
    """(n,) int64 occurrences of each value of ``idx`` (torch.bincount
    reads its input's max on the host; this stays on the device)."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def _expert_apply(toks, eids, p: Params, e: int, ecap: int):
    """Capacity-bucketed batched expert MLP. toks: (N, D); eids: (N,) in
    [0, e), or e for an empty row. Returns (per-row outputs, zeros for a
    dropped row; (N,) bool: the rows an expert took)."""
    n, d = toks.shape
    order = torch.argsort(eids, stable=True)
    eid_s = eids[order]
    counts = _counts(eid_s, e + 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=toks.device) - start[eid_s]
    ok = (eid_s < e) & (rank < ecap)
    row = torch.where(ok, eid_s, 0)
    col = torch.where(ok, rank, ecap)                        # ecap = scratch
    buf = toks.new_zeros((e, ecap + 1, d))
    buf[row, col] = toks[order] * ok[:, None].to(toks.dtype)
    buf = buf[:, :ecap]
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])
    y_sorted = torch.where(ok[:, None],
                           out_buf[row, torch.clamp(col, max=ecap - 1)], 0.0)
    y = toks.new_zeros((n, d)).index_copy_(0, order, y_sorted)
    took = torch.zeros(n, dtype=torch.bool, device=toks.device)
    return y, took.index_copy_(0, order, ok)

