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
``ecap`` follow from the shapes.

Expert parallelism (``moe_block_sharded``, under a
``distributed.context.ParallelContext`` whose model axis spans ep > 1
ranks): rank r holds the contiguous experts ``[r * e_loc, (r + 1) *
e_loc)`` (``sharding.param_specs``: the expert dim over the model axis),
the router and the shared experts whole. Two modes, as the reference's:

* ``"a2a"`` (training, prefill, the fused chunk): each rank takes its
  contiguous S / ep slice of the (model-axis replicated) tokens, routes
  them, and sends each pair to the rank that holds its expert: the pairs
  sorted stably by destination into buffers of ``cap = max(ceil(T k /
  ep * cf), 8)`` rows a destination (the rest dropped), exchanged by
  ``ParallelContext.all_to_all``, run through the rank's experts at
  ``ecap = max(ceil(ep cap / e_loc * cf), 8)`` rows each, exchanged
  back and combined at the source; the outputs are all-gathered along S.
* ``"psum"`` (decode): every rank routes every token, runs the pairs of
  its own experts (``ecap = max(ceil(T k / e_loc * cf), 8)``; other
  ranks' pairs go to the scratch bucket) and the partial outputs are
  summed over the ranks.

"a2a" falls back to "psum" where ep does not divide S, the reference's
shape rule. Each exchange moves its tensors packed as raw bytes in one
collective (the tokens with their expert ids, the outputs with the
capacity flags), so ``aux["dropped"]`` reports both capacity stages.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def _whole(name, shape):
    return None


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int, dtype,
             device, part=_whole) -> Params:
    """The MoE leaves of ``n`` stacked layers with the reference's
    distributions: the router (n, D, E) in f32 at N(0, 1/D); ``w_gate``
    and ``w_up`` (n, E, D, F) at N(0, 1/D); ``w_down`` (n, E, F, D) at
    N(0, 0.25/D) (the reference scales it by the model width, not by its
    input width F); the shared experts, one gated MLP of F x
    ``num_shared_experts``, as ``init_mlp`` draws it. Drawn in f32 one
    (D, F) slab at a time (``layers.dense_init``); ``part(name, shape)``:
    the slice of each expert leaf to keep (a rank's block of experts)."""
    mc = cfg.moe
    d, e = cfg.d_model, mc.num_experts
    f = mc.expert_d_ff or cfg.d_ff

    def experts(name, shape, scale=1.0):
        return L.dense_init(gen, shape, dtype, device, scale=scale,
                            part=part(name, shape))
    p = {"router": L.dense_init(gen, (n, d, e), torch.float32, device),
         "w_gate": experts("w_gate", (n, e, d, f)),
         "w_up": experts("w_up", (n, e, d, f)),
         "w_down": experts("w_down", (n, e, f, d),
                           scale=0.5 * math.sqrt(f / d))}
    if mc.num_shared_experts:
        fs = f * mc.num_shared_experts
        p["shared"] = {"up": L.dense_init(gen, (n, d, fs), dtype, device),
                       "gate": L.dense_init(gen, (n, d, fs), dtype, device),
                       "down": L.dense_init(gen, (n, fs, d), dtype, device)}
    return p


def capacities(cfg: ModelConfig, t: int, ep: int = 1) -> Tuple[int, int]:
    """(cap, ecap) of an "a2a" call on ``t`` tokens over ``ep`` expert
    shards: the send buffer's rows a destination and each local expert's
    rows, sized as the reference sizes them."""
    mc = cfg.moe
    cap = max(math.ceil(t * mc.top_k / ep * mc.capacity_factor), 8)
    e_loc = mc.num_experts // ep
    ecap = max(math.ceil(ep * cap / e_loc * mc.capacity_factor), 8)
    return cap, ecap


def psum_capacity(cfg: ModelConfig, t: int, ep: int) -> int:
    """ecap of a "psum" call on ``t`` tokens: each local expert's rows."""
    mc = cfg.moe
    return max(math.ceil(t * mc.top_k / (mc.num_experts // ep)
                         * mc.capacity_factor), 8)


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


def moe_block_sharded(p: Params, cfg: ModelConfig, x, par,
                      mode: str = "a2a") -> Tuple[torch.Tensor, Dict]:
    """The MoE block over ``par``'s model axis (module docstring). x: (B,
    S, D), this rank's rows (its data slice of the batch where the data
    axes divide B, else every row: ``sharding.batch_specs``, the
    reference's in_spec rule), the same on every rank of its model-axis
    row; ``p``: this rank's shard (its e_loc experts). Returns (y (B, S,
    D), the same on the row's ranks, and aux): aux["lb_loss"] this
    rank's own load-balance loss (0 under "psum"; the reference's pmean
    over every rank is left to the one caller that reads the loss,
    ``model.forward``), aux["dropped"] the (B*S*k,) mask of the pairs
    either capacity stage dropped, in (token, choice) order."""
    b, s, d = x.shape
    ep = par.tp
    if cfg.moe.num_experts % ep:
        raise ValueError(f"{cfg.moe.num_experts} experts not divisible by "
                         f"ep={ep}")
    if mode == "a2a" and s % ep:
        mode = "psum"
    if mode == "a2a":
        n = s // ep
        mine = x[:, par.model_rank * n:(par.model_rank + 1) * n]
        toks = mine.reshape(-1, d)
        y, aux = _moe_tokens(p, cfg, toks, par)
    elif mode == "psum":
        toks = x.reshape(-1, d)
        y, aux = moe_block_psum(p, cfg, x, par)
        y = y.reshape(-1, d)
    else:
        raise ValueError(f"mode {mode!r}: 'a2a' or 'psum'")
    if "shared" in p:
        y = y + L.mlp(p["shared"], cfg, toks)
    dropped = aux["dropped"]
    if mode == "a2a":
        y, dropped = _packed(lambda t: par.all_gather(t, dim=1), 2,
                             y.reshape(b, n, d),
                             dropped.reshape(b, n, -1))
    return y.reshape(b, s, d), {"lb_loss": aux["lb_loss"],
                                "dropped": dropped.reshape(-1)}


def moe_block_psum(p: Params, cfg: ModelConfig, x, par
                   ) -> Tuple[torch.Tensor, Dict]:
    """The decode form (module docstring): every rank routes every token
    of x (B, S, D) and runs the pairs its experts own; the partial
    outputs, each summed choice by choice in the model dtype, are summed
    over the model axis (with the capacity flags in k extra columns, so
    every rank learns every drop). Returns (y (B, S, D), aux: "lb_loss"
    0 and "router_fraction" None, as the reference's, and "dropped")."""
    mc = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    e, k, ep = mc.num_experts, mc.top_k, par.tp
    e_loc = e // ep
    _, gate, eidx = route(p["router"], cfg, tokens)
    flat_e = eidx.reshape(-1)
    flat_g = gate.reshape(-1).to(tokens.dtype)
    flat_tok = torch.arange(t, device=tokens.device).repeat_interleave(k)
    mine = flat_e // e_loc == par.model_rank
    local_e = torch.where(mine, flat_e % e_loc, e_loc)      # e_loc = drop
    y_pairs, ok = _expert_apply(tokens[flat_tok], local_e, p, e_loc,
                                psum_capacity(cfg, t, ep))
    y = _combine(y_pairs, flat_g, k)
    lost = (mine & ~ok).view(t, k).to(y.dtype)
    both = par.all_reduce_sum(torch.cat([y, lost], 1))
    aux = {"lb_loss": torch.zeros((), dtype=torch.float32,
                                  device=x.device),
           "router_fraction": None, "dropped": both[:, d:].reshape(-1) > 0}
    return both[:, :d].reshape(b, s, d), aux


def _packed(fn, lead: int, *ts):
    """``fn`` (a collective along one of the first ``lead`` dims) applied
    once to ``ts``, which share those dims: each is viewed as raw bytes
    behind them, the bytes concatenated, moved and split back."""
    raw = [t.contiguous().reshape(*t.shape[:lead], -1).view(torch.uint8)
           for t in ts]
    out = fn(torch.cat(raw, -1))
    got, at = [], 0
    for t, r in zip(ts, raw):
        w = r.shape[-1]
        part = out[..., at:at + w].contiguous().view(t.dtype)
        got.append(part.reshape(*out.shape[:lead], *t.shape[lead:]))
        at += w
    return got


def _moe_tokens(p: Params, cfg: ModelConfig, tokens, par=None):
    if par is not None and par.tp > 1:
        return _moe_tokens_ep(p, cfg, tokens, par)
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
    y = _combine(pair_out, flat_g, k)
    dropped = torch.ones(n_pairs, dtype=torch.bool, device=tokens.device)
    dropped[:n_send] = ~ok[:n_send]
    return y, {"lb_loss": lb_loss, "router_fraction": fe, "dropped": dropped}


def _moe_tokens_ep(p: Params, cfg: ModelConfig, tokens, par):
    """``_moe_tokens`` over ep = par.tp expert shards: the reference's
    dispatch, ``all_to_all`` each way (module docstring)."""
    mc = cfg.moe
    t, d = tokens.shape
    e, k, ep = mc.num_experts, mc.top_k, par.tp
    e_loc = e // ep
    probs, gate, eidx = route(p["router"], cfg, tokens)
    flat_e = eidx.reshape(-1)
    fe = _counts(flat_e, e).float() / (t * k)
    lb_loss = e * torch.sum(fe * probs.mean(0))
    # ---- the pairs sorted stably by destination shard, cap rows each ----
    n_pairs = t * k
    flat_g = gate.reshape(-1).to(tokens.dtype)
    flat_tok = torch.arange(t, device=tokens.device).repeat_interleave(k)
    cap, ecap = capacities(cfg, t, ep)
    dest = flat_e // e_loc
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    counts = _counts(dest_s, ep)
    rank = torch.arange(n_pairs, device=tokens.device) \
        - (torch.cumsum(counts, 0) - counts)[dest_s]
    keep = rank < cap
    col = torch.where(keep, rank, cap)                       # cap = scratch
    send_tok = tokens.new_zeros((ep, cap + 1, d))
    send_tok[dest_s, col] = tokens[flat_tok[order]]
    send_eid = torch.full((ep, cap + 1), e_loc, dtype=torch.int32,
                          device=tokens.device)              # e_loc = empty
    send_eid[dest_s, col] = (flat_e[order] % e_loc).to(torch.int32)
    # ---- exchange, the rank's experts, exchange back ---------------------
    recv_tok, recv_eid = _packed(par.all_to_all, 2, send_tok[:, :cap],
                                 send_eid[:, :cap])
    y_recv, took = _expert_apply(recv_tok.reshape(ep * cap, d),
                                 recv_eid.reshape(-1).long(), p, e_loc, ecap)
    y_back, took_back = _packed(par.all_to_all, 2,
                                y_recv.view(ep, cap, d), took.view(ep, cap))
    # ---- at the source: the gated combine, choice by choice -------------
    at = torch.clamp(col, max=cap - 1)
    ok = keep & took_back[dest_s, at]
    pair_out = tokens.new_zeros((n_pairs, d))
    pair_out[order] = torch.where(ok[:, None], y_back[dest_s, at], 0.0)
    y = _combine(pair_out, flat_g, k)
    dropped = torch.empty_like(ok)
    dropped[order] = ~ok
    return y, {"lb_loss": lb_loss, "router_fraction": fe, "dropped": dropped}


def _combine(pair_out, flat_g, k: int):
    """Each token's k gated pair outputs (rows in (token, choice) order)
    added choice by choice, each add rounded in the model dtype."""
    n, d = pair_out.shape
    gated = (pair_out * flat_g[:, None]).view(n // k, k, d)
    y = pair_out.new_zeros((n // k, d))
    for c in range(k):
        y = y + gated[:, c]
    return y


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

