"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434), in
PyTorch: the port of ``repro/models/mla.py``.

The KV cache holds the compressed latent ``c_kv`` (kv_lora_rank) and the
shared rotary key ``k_r`` (rope_head_dim) of each token, one layer's
(B, S, lora) and (B, S, rope), instead of every head's K and V. Prefill
and training run the non-absorbed form (each head's K and V expanded
from the latent); decode runs the absorbed form: the query is projected
into the latent space through ``wuk``, attends the latent cache
directly, and ``wuv`` is applied to the latent context after. The
products and roundings follow the reference's order, so a bf16 run
stays near the JAX package's.

Unlike the dense attention, decode has no kernel of its own: the
reference computes MLA in plain ``jnp`` and ignores ``decode_impl`` for
it, and so does the port. The cache writes and masks come from
``layers.decode_index`` (one per step, shared by every layer) and
``layers._scatter_slot``: a uniform step writes every row (at the last
slot when past it), a ragged or masked one writes only its live rows,
and a row with ``active`` False keeps its cache bits. With a window the
caches are rings of S slots, position p at p % S.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def init_mla(gen: torch.Generator, cfg: ModelConfig, lead, dtype,
             device) -> Params:
    """MLA projections of ``lead`` stacked layers (``()``: one) with the
    reference's leaf names and distributions (N(0, 1/in_dim), ``wo`` at
    half that std, ``kv_norm`` at one), drawn from ``gen``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wq": L.dense_init(gen, (*lead, d, h * (m.nope_head_dim
                                                + m.rope_head_dim)),
                           dtype, device),
        "wdkv": L.dense_init(gen, (*lead, d, m.kv_lora_rank), dtype, device),
        "wkr": L.dense_init(gen, (*lead, d, m.rope_head_dim), dtype, device),
        "wuk": L.dense_init(gen, (*lead, m.kv_lora_rank,
                                  h * m.nope_head_dim), dtype, device),
        "wuv": L.dense_init(gen, (*lead, m.kv_lora_rank, h * m.v_head_dim),
                            dtype, device),
        "wo": L.dense_init(gen, (*lead, h * m.v_head_dim, d), dtype, device,
                           scale=0.5),
        "kv_norm": torch.ones((*lead, m.kv_lora_rank), dtype=dtype,
                              device=device)}


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)


def _project(p: Params, cfg: ModelConfig, x, cos, sin):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), c_kv (B, S, lora),
    k_r (B, S, rope)) of x (B, S, D); ``cos`` / ``sin``: the rope tables
    of its positions at rope_head_dim."""
    m = cfg.mla
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads,
                              m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    c_kv = L.rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_r = L._rotate((x @ p["wkr"])[:, :, None, :], cos, sin)[:, :, 0]
    return q_nope, L._rotate(q_rope, cos, sin), c_kv, k_r


def mla_attention(p: Params, cfg: ModelConfig, x, positions=None,
                  window: Optional[int] = None):
    """Prefill / training path (non-absorbed). x: (B, S, D); positions:
    (B, S) or None (0..S-1); ``window``: causal sliding window (the
    config's when None). Returns (out (B, S, D), c_kv (B, S, lora), k_r
    (B, S, rope)). At S >= ``layers.FLASH_MIN_SEQ`` (and a multiple of
    ``FLASH_CHUNK``) the shared rope key joins each head's K (q/k head
    dim nope + rope, v head dim v_head_dim) and ``layers._flash_causal``
    runs; below, the two score products are summed in the model dtype,
    scaled, cast to f32 and softmaxed, as the reference orders them;
    without autograd the steps run in place, which keeps one f32 copy of
    the (B, H, S, S) scores alive (34.4 GB at 128 heads and S = 8192,
    where out-of-place steps would hold three)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    w = cfg.attention_window if window is None else window
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = L.rope_tables(positions, m.rope_head_dim, cfg.rope_theta)
    q_nope, q_rope, c_kv, k_r = _project(p, cfg, x, cos, sin)
    k_nope = (c_kv @ p["wuk"]).reshape(b, s, h, m.nope_head_dim)
    v = (c_kv @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
    if s >= L.FLASH_MIN_SEQ and s % L.FLASH_CHUNK == 0:
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        k_cat = torch.cat([k_nope, k_r[:, :, None, :].expand(
            b, s, h, m.rope_head_dim)], dim=-1)
        out = L._flash_causal(q_cat, k_cat, v, 1, w or 0)
        return out @ p["wo"], c_kv, k_r
    scores = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    scores.add_(torch.einsum("bshd,btd->bhst", q_rope, k_r))
    scores = scores.mul_(_scale(cfg)).float()
    mask = L.causal_mask(s, s, w or 0, device=x.device)
    scores.masked_fill_(~mask, L.NEG_INF)
    wts = _softmax_(scores).to(v.dtype)
    del scores
    out = torch.einsum("bhst,bthd->bshd", wts, v).reshape(b, s, -1)
    return out @ p["wo"], c_kv, k_r


def _softmax_(scores):
    """Softmax over the last axis, in place unless a gradient flows
    through ``scores`` (autograd keeps the exp's output for the
    backward)."""
    if scores.requires_grad:
        return torch.softmax(scores, dim=-1)
    scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
    return scores.div_(scores.sum(dim=-1, keepdim=True))


def init_mla_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   max_seq: int, dtype=None, device="cuda") -> Params:
    """The latent cache: "c_kv" (n_layers, B, S, lora) and "k_r"
    (n_layers, B, S, rope), zeros in the model dtype."""
    dtype = dtype or L.torch_dtype(cfg.dtype)
    m = cfg.mla
    return {"c_kv": torch.zeros((n_layers, batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_r": torch.zeros((n_layers, batch, max_seq, m.rope_head_dim),
                               dtype=dtype, device=device)}


def mla_decode(p: Params, cfg: ModelConfig, x, kv: Params,
               idx: L.DecodeIndex):
    """Absorbed decode of one token a row against one layer's latent
    cache ``kv`` ({"c_kv": (B, S, lora), "k_r": (B, S, rope)}, written in
    place at ``idx``'s slots; a row that is not live keeps its bits).
    x: (B, 1, D); ``idx``: the step's ``layers.decode_index`` over this
    cache (positions, rope tables at rope_head_dim, slots, the keys each
    row attends). The query's nope half goes through ``wuk`` into the
    latent space, both score products are summed in the model dtype and
    scaled before the f32 softmax, and the latent context goes through
    ``wuv``, in the reference's order. Returns out (B, 1, D)."""
    m = cfg.mla
    b, h = x.shape[0], cfg.num_heads
    q_nope, q_rope, c_kv, k_r = _project(p, cfg, x, idx.cos, idx.sin)
    L._scatter_slot(kv["c_kv"], c_kv[:, 0], idx)
    L._scatter_slot(kv["k_r"], k_r[:, 0], idx)
    ckv, kr = kv["c_kv"], kv["k_r"]
    wuk = p["wuk"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wuk)
    scores = (torch.einsum("bshl,btl->bhst", q_lat, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, kr)) * _scale(cfg)
    scores = torch.where(idx.valid[:, None, None], scores.float(), L.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btl->bshl", w, ckv)
    wuv = p["wuv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshl,lhd->bshd", ctx, wuv).reshape(b, 1, -1)
    return out @ p["wo"]
