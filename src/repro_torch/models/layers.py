"""Transformer building blocks of the dense GQA decoder, in PyTorch.

The dense-GQA subset of ``repro/models/layers.py``: norms, rotary
embedding, MLP, attention (full-sequence ``attention`` with its
block-causal ``_flash_causal`` above ``FLASH_MIN_SEQ``, the chunk path's
``_sdpa`` and single-token decode), the int8 KV quantizer, and the dense
(fp or int8) and paged (fp) KV caches with their masked writes. Layouts
match the JAX package at every public function: activations
``(B, S, D)``, heads ``(B, S, H, hd)``, caches token-major.

Caches are updated IN PLACE (the JAX package returns new arrays and the
engine donates the old ones; here the one persistent tensor is
written). Each function still returns the cache dict, so call sites
read like the JAX ones.

Masked writes. The JAX package makes a masked write a bitwise no-op by
scattering to an out-of-range index with ``mode="drop"``. PyTorch has
no dropping scatter, and picking the live rows out on the host
(``nonzero``) would cost a device-to-host sync per layer, inside the
decode micro-loop too. In a dense cache each row writes only its own
row, so a masked entry writes back the value it gathered from its
(clamped) target: the bits stay. In a paged pool a masked row's stale
block index may alias a live row's target, so the pool carries one
extra SINK block past its real extent (block ``num_blocks``); masked
and padding entries are redirected there, and readers see the real
pool only (``pages[:num_blocks]``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

NEG_INF = -1e30  # large-negative mask value (bf16-safe)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(f"dtype {name!r} is not supported by the "
                                  f"port (float32, bfloat16)")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    """N(0, (scale / sqrt(in_dim))^2) weights of ``shape`` = (..., in,
    out), drawn in f32 and cast, one leading index at a time so a
    stacked full-width weight never exists in f32 as a whole."""
    std = scale / math.sqrt(shape[-2])
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = (torch.randn(shape[-2:], generator=gen, dtype=torch.float32,
                               device=device) * std).to(dtype)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, gamma, eps: float = 1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim // 2,) f32 inverse frequencies; a constant per (head_dim,
    theta, device), cached so the decode loop does not rebuild it."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) for ``positions`` (..., seq): f32, shaped (..., seq, 1,
    head_dim // 2) to broadcast over heads. Every layer of a step shares
    them, so the model computes them once per step."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * freqs       # (..., S, half)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def _rotate(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Computed in
    f32 and cast back to x's dtype."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------
def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return functools.partial(F.gelu, approximate="tanh")  # jax default
    if name == "squared_relu":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def mlp(p: Params, cfg: ModelConfig, x):
    act = activation_fn(cfg.activation)
    h = x @ p["up"]
    if "gate" in p:
        h = act(x @ p["gate"]) * h
    else:
        h = act(h)
    return h @ p["down"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(p, cfg: ModelConfig, x, x_kv):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(*x.shape[:-1], cfg.num_heads, cfg.resolved_head_dim)
    return (q, *_kv(p, cfg, x_kv))


def _kv(p, cfg: ModelConfig, x_kv):
    """The K/V half of :func:`_qkv` (prefill's cache fill recomputes only
    these)."""
    hd = cfg.resolved_head_dim
    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(*x_kv.shape[:-1], cfg.num_kv_heads, hd)
    v = v.reshape(*x_kv.shape[:-1], cfg.num_kv_heads, hd)
    return k, v


def _sdpa(q, k, v, mask, q_per_kv: int):
    """q: (B,S,H,hd); k,v: (B,T,Hkv,hd); mask: (B|1, S, T) bool or None.
    Softmax in f32; the weights are cast to v's dtype before the second
    product, as in the JAX package."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, q_per_kv, hd)
    scores = torch.einsum("bsgqd,btgd->bgqst", q, k) / math.sqrt(hd)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgqst,btgd->bsgqd", w, v)
    return out.reshape(b, s, h * hd)


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0,
                device=None):
    """(s, t) boolean mask; query i attends key j iff j <= i+offset and,
    with a window, i+offset - j < window."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= (qi - kj) < window
    return m


# Block-causal "flash" prefill: at or above FLASH_MIN_SEQ tokens (and a
# multiple of FLASH_CHUNK), causal self-attention runs chunked with an
# online softmax over the lower-triangle chunk pairs only, so no (B, H,
# S, S) f32 scores exist. Module globals read at call time (tests patch
# them), as in the JAX package.
FLASH_MIN_SEQ = 8192
FLASH_CHUNK = 2048


def attention(p: Params, cfg: ModelConfig, x, positions=None,
              window: Optional[int] = None):
    """Full (or sliding-window) causal self-attention over a sequence.
    x: (B, S, D); positions: (B, S) or None (0..S-1)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, cfg, x, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    w = cfg.attention_window if window is None else window
    if s >= FLASH_MIN_SEQ and s % FLASH_CHUNK == 0:
        out = _flash_causal(q, k, v, cfg.q_per_kv, w)
    else:
        mask = causal_mask(s, s, w, device=x.device)[None]
        out = _sdpa(q, k, v, mask, cfg.q_per_kv)
    return out @ p["wo"]


def _flash_causal(q, k, v, q_per_kv: int, window: int = 0,
                  chunk: int = 0):
    """Chunked causal attention with online softmax.

    q/k/v: (B, S, H|Hkv, hd). An outer loop over query chunks, an inner
    loop over only the key chunks each query chunk can see
    (block-lower-triangle, window-clipped); the running max, sum and
    accumulator are f32, the scores are taken in the inputs' dtype and
    P goes into P.V in v's dtype, as in the JAX package."""
    b, s, h, hd = q.shape
    chunk = chunk or min(FLASH_CHUNK, s)   # module var read at call time
    hkv, hd_v = k.shape[2], v.shape[-1]
    assert s % chunk == 0, (s, chunk)
    qg = q.reshape(b, s, hkv, q_per_kv, hd)
    scale = 1.0 / math.sqrt(hd)
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for i in range(s // chunk):
        qi = qg[:, i * chunk:(i + 1) * chunk]
        m = torch.full((b, hkv, q_per_kv, chunk), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, q_per_kv, chunk, hd_v),
                          dtype=torch.float32, device=q.device)
        lo = max(0, (i * chunk - window) // chunk) if window > 0 else 0
        for j in range(lo, i + 1):
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            sco = (torch.einsum("bqgpd,bkgd->bgpqk", qi, kj) * scale).float()
            qpos, kpos = i * chunk + ar, j * chunk + ar
            valid = kpos[None, :] <= qpos[:, None]
            if window > 0:
                valid &= (qpos[:, None] - kpos[None, :]) < window
            sco = torch.where(valid, sco, NEG_INF)
            m_new = torch.maximum(m, sco.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pij = torch.exp(sco - m_new[..., None])
            l = l * alpha + pij.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgpqk,bkgd->bgpqd", pij.to(vj.dtype), vj).float()
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]
        # (b, hkv, qpk, chunk, hd_v) -> (b, chunk, h*hd_v)
        outs.append(out_i.movedim(3, 1).reshape(b, chunk, h * hd_v)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def _positions(pos, b: int, device) -> torch.Tensor:
    """Per-row int64 positions (B,) from a scalar or a (B,) array."""
    pos = torch.as_tensor(pos, device=device).long()
    return pos.expand(b) if pos.dim() == 0 else pos


# -- dense KV cache ---------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_seq: int,
                  dtype=None, device="cuda") -> Params:
    """Contiguous KV cache, (n_layers, batch, max_seq, Hkv, hd) per leaf.
    With cfg.kv_cache_dtype == "int8" the values are int8 and each
    (layer, row, token, kv head) has a scale in ``dtype``: leaves "k",
    "v" and "k_scale", "v_scale" of shape (n_layers, batch, max_seq,
    Hkv)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=dtype,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=dtype,
                                       device=device)}
    if cfg.kv_cache_dtype:
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}: the port quantizes the "
            "KV cache to int8 only, as the JAX package does")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, scales (...,) in x's dtype). The
    scale is max|x| / 127 in f32, floored at 1e-8; x is divided by that
    f32 scale, rounded half to even and clipped to +-127, and only then
    is the scale cast to x's dtype (the JAX package's order: dividing by
    the cast scale would change bits)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(x.dtype)


def dequantize_kv(q, scale):
    """int8 values times their scales, in the scales' dtype."""
    return q.to(scale.dtype) * scale[..., None]


@dataclasses.dataclass
class DecodeIndex:
    """What every layer of one decode step shares, computed once per step
    (the JAX package recomputes it per layer inside one compiled scan;
    eagerly that would cost a few dozen small launches per layer).

    pos: (B,) int64 positions; cos/sin: rope tables for them; valid:
    (B, T) bool keys each row attends (``j <= pos``); dense: ``rows``
    (0..B-1) and ``slots``, the (clamped) slot each row's new K/V goes
    to, and ``live``, whether it is written (a masked row writes its old
    value back); paged: ``flat``, the physical token index of each row's
    new K/V (the sink block for a masked row), plus the int32
    ``block_tables`` and ``seq_lens = pos + 1`` the kernel takes."""
    pos: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    valid: torch.Tensor
    rows: Optional[torch.Tensor] = None
    slots: Optional[torch.Tensor] = None
    live: Optional[torch.Tensor] = None
    flat: Optional[torch.Tensor] = None
    block_tables: Optional[torch.Tensor] = None
    seq_lens: Optional[torch.Tensor] = None


def _masked_write_idx(slot, s_max: int, active=None, uniform=False):
    """Dense write targets for one new entry per row (the JAX package's
    ``_masked_write_idx`` + ``_scatter_slot``): row b at slot[b] clamped
    to S-1, and whether the write is live. A row that is masked
    (active=False) or whose slot is past S, which the JAX package's
    ``mode="drop"`` discards, writes its old value back. A ``uniform``
    step (one scalar position, no mask) is the JAX package's
    ``dynamic_update_slice``, which clamps its start and never drops:
    every row writes, at S-1 when the slot is past S."""
    live = slot < s_max
    if uniform:
        live = torch.ones_like(live)
    elif active is not None:
        live = live & active
    return torch.clamp(slot, max=s_max - 1), live


def _scatter_slot(cache, new, idx: DecodeIndex):
    """cache[b, slots[b]] = new[b] where live, else its own old bits.
    cache: (B, S, ...) values or scales; new: (B, ...)."""
    old = cache[idx.rows, idx.slots]
    live = idx.live.view(-1, *(1,) * (new.dim() - 1))
    cache[idx.rows, idx.slots] = torch.where(live, new.to(cache.dtype), old)
    return cache


def decode_index(cfg: ModelConfig, pos, kv, active=None) -> DecodeIndex:
    """Per-step quantities of dense decode over a cache shaped like
    ``kv["k"]``, one layer's (B, S, Hkv, hd)."""
    b, s_max = kv["k"].shape[0], kv["k"].shape[1]
    uniform = torch.as_tensor(pos).dim() == 0 and active is None
    pos = _positions(pos, b, kv["k"].device)
    cos, sin = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    slots, live = _masked_write_idx(pos, s_max, active, uniform)
    valid = torch.arange(s_max, device=pos.device)[None, :] <= pos[:, None]
    return DecodeIndex(pos, cos, sin, valid,
                       rows=torch.arange(b, device=pos.device), slots=slots,
                       live=live)


def paged_decode_index(cfg: ModelConfig, pos, kv, block_tables,
                       active=None) -> DecodeIndex:
    """Per-step quantities of paged decode over a pool shaped like
    ``kv["k"]``, one layer's (P+1, BLOCK_S, Hkv, hd)."""
    p_blocks, bs = kv["k"].shape[0] - 1, kv["k"].shape[1]
    b, nb = block_tables.shape
    pos = _positions(pos, b, kv["k"].device)
    cos, sin = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    logical = torch.clamp(pos // bs, 0, nb - 1)
    phys = block_tables.long().gather(1, logical[:, None])[:, 0]
    flat = phys * bs + pos % bs
    if active is not None:
        flat = torch.where(active, flat, p_blocks * bs)
    valid = torch.arange(nb * bs, device=pos.device)[None, :] <= pos[:, None]
    return DecodeIndex(pos, cos, sin, valid, flat=flat,
                       block_tables=block_tables.to(torch.int32).contiguous(),
                       seq_lens=(pos + 1).to(torch.int32))


def _decode_qkv(p, cfg, x, idx: DecodeIndex):
    q, k, v = _qkv(p, cfg, x, x)
    return _rotate(q, idx.cos, idx.sin), _rotate(k, idx.cos, idx.sin), v


def decode_attention(p: Params, cfg: ModelConfig, x, kv, pos,
                     decode_impl: str = "kernel", active=None, idx=None):
    """Single-token decode against one layer's dense cache (full
    attention). x: (B,1,D); kv: {"k","v"} (B, S, Hkv, hd), plus int8
    "k_scale"/"v_scale" (B, S, Hkv) for a quantized cache; pos: (B,) or
    scalar absolute position of the new token; ``idx``: the step's
    :func:`decode_index` when the caller shares it across layers. Rows
    with active=False leave their cache row bit-identical, scales
    included. An int8 cache takes the new token quantized, and the whole
    cache is dequantized for the attention, as in the JAX package. The
    kernel gets ``valid = j <= pos``. Returns (out, kv)."""
    b = x.shape[0]
    if idx is None:
        idx = decode_index(cfg, pos, kv, active)
    q, k, v = _decode_qkv(p, cfg, x, idx)
    if "k_scale" in kv:
        for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
            vals, scale = quantize_kv(new)
            _scatter_slot(kv[name], vals, idx)
            _scatter_slot(kv[name + "_scale"], scale, idx)
        k_cache = dequantize_kv(kv["k"], kv["k_scale"])
        v_cache = dequantize_kv(kv["v"], kv["v_scale"])
    else:
        _scatter_slot(kv["k"], k[:, 0], idx)
        _scatter_slot(kv["v"], v[:, 0], idx)
        k_cache, v_cache = kv["k"], kv["v"]
    if decode_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.gqa_decode(q[:, 0].contiguous(), k_cache, v_cache,
                              idx.valid, active).reshape(b, 1, -1)
    elif decode_impl == "torch":
        out = _sdpa(q, k_cache, v_cache, idx.valid[:, None, :],
                    cfg.q_per_kv)
    else:
        raise ValueError(f"decode_impl must be 'kernel' or 'torch', got "
                         f"{decode_impl!r}")
    return out @ p["wo"], kv


# -- paged KV cache ---------------------------------------------------------
def init_paged_kv_cache(cfg: ModelConfig, n_layers: int, num_blocks: int,
                        block_size: int, dtype=None, device="cuda") -> Params:
    """Paged KV cache: a pool of ``num_blocks`` physical blocks of
    ``block_size`` tokens per layer, (n_layers, num_blocks + 1,
    block_size, Hkv, hd) per leaf; block ``num_blocks`` is the write
    sink (module docstring). Slots own blocks through the engine's
    block tables."""
    if cfg.kv_cache_dtype:
        raise NotImplementedError("paged KV cache is fp-only")
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (n_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_scatter_tokens(pages, new, flat_idx):
    """Scatter per-token K/V entries into one layer's block pool.

    pages: (P+1, BLOCK_S, Hkv, hd) with the sink block; new: (N, Hkv,
    hd); flat_idx: (N,) physical token index (phys_block * BLOCK_S +
    offset). Indices outside the P real blocks (masked rows and padding
    carry P*BLOCK_S) land in the sink block: the JAX package drops them,
    and either way the real pool stays bit-identical."""
    n_real = (pages.shape[0] - 1) * pages.shape[1]
    flat = pages.view(-1, *pages.shape[2:])
    idx = torch.where((flat_idx >= 0) & (flat_idx < n_real), flat_idx,
                      n_real)
    flat[idx] = new.to(pages.dtype)
    return pages


def gather_pages(pages, block_tables):
    """(P, BLOCK_S, Hkv, hd) x (B, NB) -> (B, NB*BLOCK_S, Hkv, hd): each
    slot's contiguous row through its block table, entries clamped to
    [0, P-1] (a stale or unallocated entry reads a real block, which the
    causal mask then hides). Rows may alias blocks."""
    b, nb = block_tables.shape
    bs = pages.shape[1]
    bt = block_tables.long().clamp(0, pages.shape[0] - 1)
    return pages[bt].reshape(b, nb * bs, *pages.shape[2:])


def gather_blocks(pages, idx):
    """Swap-out half of the host KV tier: exactly the named physical
    blocks of an engine-level pool leaf, (L, P+1, BLOCK_S, ...) x (NB,)
    -> (L, NB, BLOCK_S, ...), a new tensor (``index_select``). The
    blocks are copied verbatim, so a later swap-in restores identical
    bits whatever physical blocks it lands in."""
    return pages.index_select(1, idx)


def scatter_blocks(pages, vals, idx):
    """Swap-in half: write (L, NB, BLOCK_S, ...) block contents into the
    pool in place at freshly allocated physical indices ``idx`` (NB,),
    which no other slot references."""
    return pages.index_copy_(1, idx, vals.to(pages.dtype))


def gather_slot_row(leaf, s: int):
    """Dense-cache analog of :func:`gather_blocks`: a copy of slot ``s``'s
    cache row, (L, B, S, ...) -> (L, S, ...)."""
    return leaf[:, s].clone()


def scatter_slot_row(leaf, row, s: int):
    """Dense-cache analog of :func:`scatter_blocks`: write a swapped row
    back into (possibly another) slot ``s``, in place."""
    leaf[:, s].copy_(row)
    return leaf


def paged_decode_attention(p: Params, cfg: ModelConfig, x, kv, block_tables,
                           pos, decode_impl: str = "kernel", active=None,
                           idx=None):
    """Single-token decode against one layer's paged pool. x: (B,1,D);
    kv: {"k","v"} (P+1, BLOCK_S, Hkv, hd) with the sink block;
    block_tables: (B, NB) int; pos: (B,) absolute position of the new
    token; ``idx``: the step's :func:`paged_decode_index` when shared
    across layers. The kernel gets ``seq_lens = pos + 1``. Same math as
    :func:`decode_attention` on the gathered pages. Returns (out, kv)."""
    b = x.shape[0]
    p_blocks = kv["k"].shape[0] - 1
    if idx is None:
        idx = paged_decode_index(cfg, pos, kv, block_tables, active)
    q, k, v = _decode_qkv(p, cfg, x, idx)
    paged_scatter_tokens(kv["k"], k[:, 0], idx.flat)
    paged_scatter_tokens(kv["v"], v[:, 0], idx.flat)
    k_pages, v_pages = kv["k"][:p_blocks], kv["v"][:p_blocks]
    if decode_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.paged_gqa_decode(
            q[:, 0].contiguous(), k_pages, v_pages, idx.block_tables,
            idx.seq_lens, active).reshape(b, 1, -1)
    elif decode_impl == "torch":
        k_all = gather_pages(k_pages, block_tables)
        v_all = gather_pages(v_pages, block_tables)
        out = _sdpa(q, k_all, v_all, idx.valid[:, None, :], cfg.q_per_kv)
    else:
        raise ValueError(f"decode_impl must be 'kernel' or 'torch', got "
                         f"{decode_impl!r}")
    return out @ p["wo"], kv


def paged_chunk_index(block_tables, start, lengths, l: int, kv):
    """(B*L,) physical token index of each chunk token in a pool shaped
    like ``kv["k"]``; padding tokens (index >= lengths) get the sink
    block's. Shared by every layer of the chunk."""
    p_blocks, bs = kv["k"].shape[0] - 1, kv["k"].shape[1]
    nb = block_tables.shape[1]
    start, lengths = start.long(), lengths.long()
    pos = start[:, None] + torch.arange(l, device=start.device)[None, :]
    logical = torch.clamp(pos // bs, 0, nb - 1)
    phys = block_tables.long().gather(1, logical)
    flat = phys * bs + pos % bs
    valid = torch.arange(l, device=start.device)[None, :] < lengths[:, None]
    return torch.where(valid, flat, p_blocks * bs).reshape(-1)


def write_chunk_kv_paged(kv: Params, k, v, block_tables, start,
                         lengths, flat=None) -> Params:
    """Write one prefill chunk per batch row into one layer's block pool
    through the block table. k/v: (B, L, Hkv, hd); start: (B,) first
    absolute position; lengths: (B,) valid tokens (0 => the row writes
    nothing); ``flat``: the chunk's :func:`paged_chunk_index` when shared
    across layers. Padding tokens go to the sink block."""
    b, l = k.shape[:2]
    if flat is None:
        flat = paged_chunk_index(block_tables, start, lengths, l, kv)
    paged_scatter_tokens(kv["k"], k.reshape(b * l, *k.shape[2:]), flat)
    paged_scatter_tokens(kv["v"], v.reshape(b * l, *v.shape[2:]), flat)
    return kv


# -- chunked prefill (batched multi-slot) -----------------------------------
def chunk_write_index(start, lengths, l: int, kv):
    """Where each token of a (B, L) chunk goes in a dense cache shaped
    like ``kv["k"]``, one layer's (B, S, ...): the JAX package's per-row
    dynamic_update_slice at ``start``, keeping old values where the token
    index >= lengths. The start + L > S overhang (the last chunk of a
    near-capacity prompt) is handled as there: the window is clamped to
    [0, S-L] and the chunk rolled by the clamp's shift, so every valid
    token lands at its absolute position. Returns (rows, src_cols,
    dst_pos, keep), each (B, L): window position (rows, dst_pos) takes
    chunk token (rows, src_cols) where ``keep``, else its own old value.
    Shared by every layer of the chunk."""
    b = start.shape[0]
    s_max = kv["k"].shape[1]
    start, lengths = start.long(), lengths.long()
    st_eff = torch.clamp(start, 0, s_max - l)
    shift = (start - st_eff)[:, None]                 # > 0 only on overhang
    w = torch.arange(l, device=start.device)[None, :]
    rows = torch.arange(b, device=start.device)[:, None].expand(b, l)
    src_cols = (w - shift) % l                        # jnp.roll(new, shift)
    keep = (w >= shift) & ((w - shift) < lengths[:, None])
    return rows, src_cols, st_eff[:, None] + w, keep


def write_chunk_kv(kv: Params, k, v, start, lengths, index=None) -> Params:
    """Write one prefill chunk per batch row into one layer's dense cache
    at per-row offsets. k/v: (B, L, Hkv, hd); start: (B,); lengths: (B,)
    valid tokens (0 => that row is a bitwise no-op); ``index``: the
    chunk's :func:`chunk_write_index` when shared across layers. Entries
    past a row's length keep their old contents."""
    if index is None:
        index = chunk_write_index(start, lengths, k.shape[1], kv)
    _blend_rows(kv["k"], k, index)
    _blend_rows(kv["v"], v, index)
    return kv


def _blend_rows(cache, new, index):
    """The (B, L) window of a :func:`chunk_write_index` takes the kept
    chunk tokens and writes its own old values back elsewhere: each
    row's kept tokens land at their absolute positions, and nothing
    else of the cache changes."""
    rows, src_cols, dst_pos, keep = index
    old = cache[rows, dst_pos]
    cache[rows, dst_pos] = torch.where(keep[..., None, None],
                                       new[rows, src_cols].to(cache.dtype),
                                       old)
    return cache
