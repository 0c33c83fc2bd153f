"""Model assembly for the dense GQA decoder, in PyTorch.

The DENSE branch of ``repro/models/model.py``, with the same functional
API and layouts:

  init_params(cfg, seed, device)                           -> params
  init_cache(cfg, batch, cache_len, device)                -> cache
  init_paged_cache(cfg, num_blocks, block_size, device)    -> cache
  decode_step / prefill_chunk / mixed_step                 -> (logits, cache)
  paged_decode_step / paged_prefill_chunk / paged_mixed_step
  verify_step / paged_verify_step          -> (logits (B, L, V), cache)

Parameters are a nested dict of tensors whose per-layer leaves stay
stacked along a leading layer axis, as in the JAX pytree; layer ``i`` is
``layers[...][i]``. The layer loop is a Python loop (JAX scans it).
Caches are updated in place and returned (models/layers.py). Other
families, MLA, sliding windows and the int8 KV cache raise
NotImplementedError: they are later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    run: anything but a dense, full-attention, fp-cache decoder."""
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs dense decoders; the other "
            "families are a later slice")
    if cfg.mla is not None:
        raise NotImplementedError("MLA is a later slice of the port")
    if cfg.attention_window:
        raise NotImplementedError("sliding-window attention is a later "
                                  "slice of the port")
    if cfg.kv_cache_dtype:
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} "
                                  "is a later slice of the port")


# ===========================================================================
# init
# ===========================================================================
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the JAX package's distributions (embedding
    N(0, 0.02^2), projections N(0, 1/in_dim), ``wo`` at half that std,
    norms at one), drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``. The numbers differ from JAX's for the same seed; the
    tests carry JAX's parameters across with params.from_jax_numpy."""
    check_supported(cfg)
    dtype = L.torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    for lo in range(0, cfg.vocab_size, 1 << 15):   # f32 draws in slabs
        hi = min(cfg.vocab_size, lo + (1 << 15))
        embed[lo:hi] = (torch.randn((hi - lo, d), generator=gen,
                                    dtype=torch.float32, device=device)
                        * 0.02).to(dtype)
    p: Params = {"embed": embed, "final_ln": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dtype, device)
    attn = {"wq": L.dense_init(gen, (n, d, h * hd), dtype, device),
            "wk": L.dense_init(gen, (n, d, hkv * hd), dtype, device),
            "wv": L.dense_init(gen, (n, d, hkv * hd), dtype, device),
            "wo": L.dense_init(gen, (n, h * hd, d), dtype, device,
                               scale=0.5)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, h * hd), dtype=dtype, device=device)
        attn["bk"] = torch.zeros((n, hkv * hd), dtype=dtype, device=device)
        attn["bv"] = torch.zeros((n, hkv * hd), dtype=dtype, device=device)
    mlp = {"up": L.dense_init(gen, (n, d, cfg.d_ff), dtype, device)}
    if cfg.activation != "squared_relu":     # gated MLP; nemotron has none
        mlp["gate"] = L.dense_init(gen, (n, d, cfg.d_ff), dtype, device)
    mlp["down"] = L.dense_init(gen, (n, cfg.d_ff, d), dtype, device)
    p["layers"] = {"ln1": ones(n, d), "ln2": ones(n, d), "attn": attn,
                   "mlp": mlp}
    return p


def _unstack(tree) -> List:
    """Per-layer views of a tree of stacked tensors: [tree[..][i]]."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def _head(params: Params, cfg: ModelConfig, x):
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def _mlp_residual(lp, cfg, x):
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h)


# ===========================================================================
# caches
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> Params:
    """Dense KV cache for ``batch`` slots of ``cache_len`` tokens."""
    check_supported(cfg)
    return {"kv": L.init_kv_cache(cfg, cfg.num_layers, batch, cache_len,
                                  device=device)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Params:
    """Paged KV cache: one pool of ``num_blocks`` physical blocks per
    layer (plus the sink block); slots own blocks via block tables."""
    check_supported(cfg)
    return {"kv": L.init_paged_kv_cache(cfg, cfg.num_layers, num_blocks,
                                        block_size, device=device)}


# ===========================================================================
# decode / prefill
# ===========================================================================
def decode_step(params: Params, cfg: ModelConfig, token, cache: Params, pos,
                decode_impl: str = "kernel", active=None
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B,1) int; pos: scalar or (B,) per-row positions; active:
    optional (B,) bool — rows with active=False leave the cache
    bit-identical and get garbage logits. Returns (logits (B,V), cache)."""
    check_supported(cfg)
    x = params["embed"][token.long()]
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    idx = L.decode_index(cfg, pos, {"k": ks[0]}, active)
    for lp, k, v in zip(_unstack(params["layers"]), ks, vs):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.decode_attention(lp["attn"], cfg, h, {"k": k, "v": v},
                                  idx.pos, decode_impl=decode_impl,
                                  active=active, idx=idx)
        x = _mlp_residual(lp, cfg, x + a)
    return _head(params, cfg, x)[:, 0], cache


def paged_decode_step(params: Params, cfg: ModelConfig, token,
                      cache: Params, block_tables, pos,
                      decode_impl: str = "kernel", active=None
                      ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`decode_step`; block_tables: (B, NB) int."""
    check_supported(cfg)
    x = params["embed"][token.long()]
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    idx = L.paged_decode_index(cfg, pos, {"k": ks[0]}, block_tables, active)
    for lp, k, v in zip(_unstack(params["layers"]), ks, vs):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.paged_decode_attention(lp["attn"], cfg, h, {"k": k, "v": v},
                                        block_tables, idx.pos,
                                        decode_impl=decode_impl,
                                        active=active, idx=idx)
        x = _mlp_residual(lp, cfg, x + a)
    return _head(params, cfg, x)[:, 0], cache


def _chunk_attention(lp, cfg, x, rope, valid, kv_view):
    """Attention half of one fused prefill layer. ``rope``: the chunk
    positions' (cos, sin); ``valid``: (B, L, T) keys each query sees
    (cache entries j <= its position); ``kv_view(k, v)`` writes the
    chunk's K/V and returns the (B, T, Hkv, hd) keys/values the queries
    attend (cache prefix + this chunk)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L._qkv(lp["attn"], cfg, h, h)
    q, k = L._rotate(q, *rope), L._rotate(k, *rope)
    k_all, v_all = kv_view(k, v)
    a = L._sdpa(q, k_all, v_all, valid, cfg.q_per_kv)
    return x + a @ lp["attn"]["wo"]


def _last_logits(params, cfg, x, lengths):
    """LM head over each row's last valid chunk position only."""
    b, l, d = x.shape
    last = torch.clamp(lengths - 1, 0, l - 1)
    x = x.gather(1, last[:, None, None].expand(b, 1, d))
    return _head(params, cfg, x)[:, 0]


def _chunk_inputs(params, cfg, tokens, start_pos, lengths, t_max: int):
    """Per-chunk quantities every layer shares: embeddings, rope tables
    of the chunk positions, and the (B, L, T) causal validity."""
    b, l = tokens.shape
    start_pos = torch.as_tensor(start_pos, device=tokens.device).long()
    lengths = torch.as_tensor(lengths, device=tokens.device).long()
    x = params["embed"][tokens.long()]
    positions = start_pos[:, None] + torch.arange(l, device=x.device)[None]
    rope = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    valid = torch.arange(t_max, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    return x, start_pos, lengths, rope, valid


def prefill_chunk(params: Params, cfg: ModelConfig, tokens, cache: Params,
                  start_pos, lengths, decode_impl: str = "kernel"
                  ) -> Tuple[torch.Tensor, Params]:
    """Batched multi-slot chunked prefill: one call advances every row by
    up to L tokens. tokens: (B, L) zero-padded chunks; start_pos: (B,);
    lengths: (B,) valid tokens (0 => bitwise no-op row). Returns
    (logits after each row's last valid token (B, V), cache). The dense
    full-attention model runs the fused sequence-level chunk
    (``decode_impl`` is unused there, as in the JAX package)."""
    check_supported(cfg)
    return _prefill_chunk_fused(params, cfg, tokens, cache, start_pos,
                                lengths)


def _prefill_chunk_fused(params, cfg, tokens, cache, start_pos, lengths,
                         all_logits: bool = False):
    """Write the chunk's K/V into the cache in place, then attend the
    chunk's queries over (cache prefix + chunk) causally. ``all_logits``
    (the speculative verify path) returns the LM head over every chunk
    position, (B, L, V), instead of each row's last."""
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    x, start_pos, lengths, rope, valid = _chunk_inputs(
        params, cfg, tokens, start_pos, lengths, ks[0].shape[1])
    index = L.chunk_write_index(start_pos, lengths, tokens.shape[1],
                                {"k": ks[0]})
    for lp, kc, vc in zip(_unstack(params["layers"]), ks, vs):
        def kv_view(k, v, kc=kc, vc=vc):
            L.write_chunk_kv({"k": kc, "v": vc}, k, v, start_pos, lengths,
                             index=index)
            return kc, vc
        x = _mlp_residual(lp, cfg, _chunk_attention(lp, cfg, x, rope, valid,
                                                    kv_view))
    return _chunk_logits(params, cfg, x, lengths, all_logits), cache


def _chunk_logits(params, cfg, x, lengths, all_logits: bool):
    return _head(params, cfg, x) if all_logits \
        else _last_logits(params, cfg, x, lengths)


def paged_prefill_chunk(params: Params, cfg: ModelConfig, tokens,
                        cache: Params, block_tables, start_pos, lengths,
                        all_logits: bool = False
                        ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`prefill_chunk`: the chunk's K/V go through
    the block table, and the queries attend the gathered pages."""
    check_supported(cfg)
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    p_blocks, bs = ks[0].shape[0] - 1, ks[0].shape[1]
    x, start_pos, lengths, rope, valid = _chunk_inputs(
        params, cfg, tokens, start_pos, lengths,
        block_tables.shape[1] * bs)
    flat = L.paged_chunk_index(block_tables, start_pos, lengths,
                               tokens.shape[1], {"k": ks[0]})
    for lp, kc, vc in zip(_unstack(params["layers"]), ks, vs):
        def kv_view(k, v, kc=kc, vc=vc):
            L.write_chunk_kv_paged({"k": kc, "v": vc}, k, v, block_tables,
                                   start_pos, lengths, flat=flat)
            return (L.gather_pages(kc[:p_blocks], block_tables),
                    L.gather_pages(vc[:p_blocks], block_tables))
        x = _mlp_residual(lp, cfg, _chunk_attention(lp, cfg, x, rope, valid,
                                                    kv_view))
    return _chunk_logits(params, cfg, x, lengths, all_logits), cache


def verify_step(params: Params, cfg: ModelConfig, tokens, cache: Params,
                start_pos, lengths) -> Tuple[torch.Tensor, Params]:
    """Speculative multi-token verify: advance every row by its
    [last_tok, draft_1..draft_w] window in one call and return the logits
    at EVERY window position, so the caller can accept the longest draft
    prefix matching the model's own greedy argmax. It is the fused
    :func:`prefill_chunk` (the port runs dense full attention only) with
    the LM head over all L positions; ``lengths == 0`` rows stay bitwise
    no-ops, and a rejected position's K/V is overwritten by the next
    write there. tokens: (B, L); start_pos/lengths: (B,). Returns (logits
    (B, L, V), cache); positions past ``lengths`` and idle rows hold
    garbage the caller masks."""
    check_supported(cfg)
    return _prefill_chunk_fused(params, cfg, tokens, cache, start_pos,
                                lengths, all_logits=True)


def paged_verify_step(params: Params, cfg: ModelConfig, tokens,
                      cache: Params, block_tables, start_pos, lengths
                      ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`verify_step`: the
    :func:`paged_prefill_chunk` pass with the LM head over all window
    positions. Returns (logits (B, L, V), cache)."""
    return paged_prefill_chunk(params, cfg, tokens, cache, block_tables,
                               start_pos, lengths, all_logits=True)


def mixed_step(params: Params, cfg: ModelConfig, tokens, cache: Params, pos,
               lengths, decode_tokens, decode_active,
               decode_impl: str = "kernel") -> Tuple[torch.Tensor, Params]:
    """Fused prefill + decode: advance every prefill row (lengths > 0) by
    one chunk and every decode row (decode_active) by one token in one
    call. The row sets are disjoint and each half is exactly the
    separate call, so the tokens equal the sequential path's. Returns
    (decode logits (B, V), cache)."""
    _, cache = prefill_chunk(params, cfg, tokens, cache, pos, lengths)
    return decode_step(params, cfg, decode_tokens, cache, pos,
                       decode_impl=decode_impl, active=decode_active)


def paged_mixed_step(params: Params, cfg: ModelConfig, tokens,
                     cache: Params, block_tables, pos, lengths,
                     decode_tokens, decode_active,
                     decode_impl: str = "kernel"
                     ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`mixed_step`."""
    _, cache = paged_prefill_chunk(params, cfg, tokens, cache, block_tables,
                                   pos, lengths)
    return paged_decode_step(params, cfg, decode_tokens, cache,
                             block_tables, pos, decode_impl=decode_impl,
                             active=decode_active)
