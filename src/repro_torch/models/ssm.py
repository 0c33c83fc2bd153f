"""Recurrent blocks, in PyTorch: Mamba2 (SSD, chunked scan) and xLSTM
(mLSTM + sLSTM), the port of ``repro/models/ssm.py``.

The sequence is processed in chunks of ``cfg.ssm.chunk_size``: within a
chunk the scan is a masked (Q, Q) decay kernel and batched matmuls, and
a Python loop over the chunks carries the recurrent state (the JAX
package's inter-chunk ``lax.scan``). sLSTM is strictly sequential, a
loop over T. Decode is one O(1) state update.

State conventions (as the reference's):
  mamba2 : {"h": (B, H, P, N) f32, "conv": (B, 3, C) model dtype}
  mlstm  : {"c": (B, H, P, P) f32}
  slstm  : (c, n, h), each (B, H, P) f32

The dtype changes where the reference has them, which sets the bf16
drift: the decay kernels are cast to the input's dtype before their
matmuls, the carried chunk states to it for the inter-chunk term; the
chunk-state weights multiply the operand the reference's three-way
einsum multiplies first (Mamba2: x; mLSTM: v), and Mamba2's decode
forms dt * B before x, as its einsum does;
``dt`` goes through softplus in f32; decode updates the state in f32
and casts the output back; the mLSTM gates are ``xm.float() @ wif``.
``F.softplus`` is linear above its threshold of 20, where
``jax.nn.softplus`` is not: the two differ by ~2e-9 there.

A sequence longer than one chunk must be a multiple of it (the
reference's assert): nothing pads it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

HEAD_P = 64  # channels per recurrent head

Params = Dict[str, torch.Tensor]


def _tril_mask(q: int, device) -> torch.Tensor:
    """(1, 1, Q, Q, 1) bool: key j <= query i."""
    return torch.tril(torch.ones((q, q), dtype=torch.bool, device=device)
                      )[None, None, :, :, None]


def _decay(cum):
    """exp(cum_i - cum_j) for j <= i, 0 above the diagonal: cum (B, nc,
    Q, H) -> (B, nc, Q, Q, H). The upper triangle is set to -inf BEFORE
    the exp (its entries are positive and would overflow, and their grad
    would poison the backward pass with NaNs)."""
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    li = li.masked_fill(~_tril_mask(cum.shape[2], cum.device), -math.inf)
    return torch.exp(li)


def _carry(s_chunk, chunk_decay, h0):
    """The inter-chunk recurrence h <- h * decay + s over the chunks
    (the reference's ``lax.scan``): s_chunk (B, nc, H, P, V) f32,
    chunk_decay (B, nc, H). Returns (final state, the state entering each
    chunk (B, nc, H, P, V))."""
    h, prevs = h0, []
    for c in range(s_chunk.shape[1]):
        prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    return h, torch.stack(prevs, dim=1)


# ===========================================================================
# Mamba2 (simplified SSD; single B/C group shared across heads)
# ===========================================================================
def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // HEAD_P
    return d_inner, n_heads, cfg.ssm.state_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, lead: Tuple, dtype,
                device) -> Params:
    """The Mamba2 leaves of ``lead`` stacked layers, with the reference's
    distributions: the fused input projection [z, x, B, C, dt] and the
    output projection (at half scale) as ``layers.dense_init``; ``a_log``
    log(linspace(1, 16, H)) and ``dt_bias`` zeros, both f32 whatever the
    dtype; ``d_skip`` ones; the depthwise conv kernel (4, C) at N(0,
    0.01)."""
    d = cfg.d_model
    d_inner, nh, n = mamba2_dims(cfg)
    lead = tuple(lead)
    conv = torch.randn(lead + (4, d_inner + 2 * n), generator=gen,
                       dtype=torch.float32, device=device) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    return {
        "in_proj": L.dense_init(gen, lead + (d, 2 * d_inner + 2 * n + nh),
                                dtype, device),
        "out_proj": L.dense_init(gen, lead + (d_inner, d), dtype, device,
                                 scale=0.5),
        "a_log": a_log.expand(lead + (nh,)).clone(),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32,
                               device=device),
        "d_skip": torch.ones(lead + (nh,), dtype=dtype, device=device),
        "conv": conv.to(dtype),
    }


def _split_proj(p, cfg: ModelConfig, u):
    d_inner, n_heads, n = mamba2_dims(cfg)
    z, xbc, dt = torch.split(u @ p["in_proj"],
                             [d_inner, d_inner + 2 * n, n_heads], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv, state=None):
    """Depthwise causal conv, kernel 4. xbc: (B, T, C); state: (B, 3, C),
    the last three inputs before xbc (zeros when None). Returns
    (silu(out), the new state: the last three rows of [state, xbc])."""
    k = conv.shape[0]
    pad = torch.zeros_like(xbc[:, :k - 1]) if state is None else state
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1]] * conv[i] for i in range(k))
    return F.silu(out), xp[:, -(k - 1):]


def mamba2_forward(p: Params, cfg: ModelConfig, u, h0=None):
    """u: (B, T, D). Returns (y (B, T, D), h_final (B, H, P, N) f32).
    Chunked SSD scan."""
    return mamba2_scan(p, cfg, *_split_proj(p, cfg, u), h0)


def mamba2_scan(p: Params, cfg: ModelConfig, z, xbc, dt, h0=None):
    """:func:`mamba2_forward` from its input projection ``_split_proj``
    (z, xbc, dt), so that a caller that also keeps the pre-activation
    ``xbc`` (the prefill's conv state) projects once."""
    b, t, _ = z.shape
    d_inner, nh, n = mamba2_dims(cfg)
    q = min(cfg.ssm.chunk_size, t)
    assert t % q == 0, f"seq {t} not divisible by chunk {q}"
    nc = t // q
    xbc, _ = _causal_conv(xbc, p["conv"])
    x, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    x = x.reshape(b, t, nh, HEAD_P)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,T,H)
    da = dt * -torch.exp(p["a_log"])                              # < 0

    # chunk views
    xc = x.reshape(b, nc, q, nh, HEAD_P)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, nh)
    cum = torch.cumsum(da.reshape(b, nc, q, nh), dim=2)          # (B,nc,Q,H)

    # intra-chunk (lower-triangular decay kernel)
    gbc = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None]      # (B,nc,Q,Q,1)
    kern = (gbc * _decay(cum) * dtc[:, :, None, :, :]).to(z.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", kern, xc)

    # chunk-final states
    seg = torch.exp(cum[:, :, -1:, :] - cum)                      # (B,nc,Q,H)
    xw = xc * (seg * dtc).to(z.dtype)[..., None]
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", bc, xw)           # (B,nc,H,P,N)
    if h0 is None:
        h0 = torch.zeros((b, nh, HEAD_P, n), dtype=torch.float32,
                         device=z.device)
    h_final, h_prevs = _carry(s_chunk.float(), torch.exp(cum[:, :, -1, :]),
                              h0)

    # inter-chunk contribution
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, h_prevs.to(z.dtype)) \
        * torch.exp(cum).to(z.dtype)[..., None]
    y = (y_intra + y_inter).reshape(b, t, nh, HEAD_P)
    y = y + x * p["d_skip"][None, None, :, None]
    y = y.reshape(b, t, d_inner) * F.silu(z)
    return y @ p["out_proj"], h_final


def init_mamba2_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    _, nh, n = mamba2_dims(cfg)
    return {"h": torch.zeros((batch, nh, HEAD_P, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, 3, cfg.ssm.expand * cfg.d_model
                                 + 2 * cfg.ssm.state_dim),
                                dtype=L.torch_dtype(cfg.dtype),
                                device=device)}


def mamba2_decode(p: Params, cfg: ModelConfig, u, state):
    """u: (B, 1, D); O(1) recurrent update. Returns (y, new state)."""
    b = u.shape[0]
    d_inner, nh, n = mamba2_dims(cfg)
    z, xbc, dt = _split_proj(p, cfg, u)
    xbc, conv_state = _causal_conv(xbc, p["conv"], state["conv"])
    x, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    x = x.reshape(b, nh, HEAD_P)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]             # (B,H)
    dec = torch.exp(dt * -torch.exp(p["a_log"]))                  # (B,H)
    dtb = dt[:, :, None] * bmat[:, 0].float()[:, None, :]         # (B,H,N)
    h = state["h"] * dec[:, :, None, None] \
        + x.float()[..., None] * dtb[:, :, None, :]
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h)
    y = y.to(u.dtype) + x * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner) * F.silu(z)
    return y @ p["out_proj"], {"h": h, "conv": conv_state}


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory, sequential)
# ===========================================================================
def xlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    n_heads = cfg.num_heads
    return cfg.d_model // n_heads, n_heads   # (head dim, heads)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, lead: Tuple, dtype,
               device) -> Params:
    """The mLSTM leaves of ``lead`` stacked layers: the up projection to
    [xm, z], the q / k / v projections and the down projection (half
    scale) as ``layers.dense_init``, and the input / forget gates ``wif``
    in f32 whatever the dtype."""
    d = cfg.d_model
    d_up = cfg.ssm.expand * d
    lead = tuple(lead)
    return {
        "up": L.dense_init(gen, lead + (d, 2 * d_up), dtype, device),
        "wq": L.dense_init(gen, lead + (d_up, d_up), dtype, device),
        "wk": L.dense_init(gen, lead + (d_up, d_up), dtype, device),
        "wv": L.dense_init(gen, lead + (d_up, d_up), dtype, device),
        "wif": L.dense_init(gen, lead + (d_up, 2 * cfg.num_heads),
                            torch.float32, device),
        "down": L.dense_init(gen, lead + (d_up, d), dtype, device,
                             scale=0.5),
    }


def _mlstm_heads(cfg, d_up):
    nh = cfg.num_heads
    return nh, d_up // nh


def _mlstm_gates(cfg, gates):
    """(input gate exp(min(i, 8)), forget gate sigmoid(f)) of the f32
    gate pre-activations [i, f]."""
    nh = cfg.num_heads
    return torch.exp(torch.clamp(gates[..., :nh], max=8.0)), \
        torch.sigmoid(gates[..., nh:])


def mlstm_forward(p: Params, cfg: ModelConfig, u, state=None):
    """Post-up-projection mLSTM; chunked linear-attention form with a
    per-head scalar forget decay. u: (B, T, D). Returns (y, {"c"})."""
    b, t, _ = u.shape
    d_up = p["wq"].shape[0]
    nh, hp = _mlstm_heads(cfg, d_up)
    q_len = min(cfg.ssm.chunk_size, t)
    assert t % q_len == 0, f"seq {t} not divisible by chunk {q_len}"
    nc = t // q_len
    xm, z = (u @ p["up"]).chunk(2, dim=-1)
    q = (xm @ p["wq"]).reshape(b, t, nh, hp) / math.sqrt(hp)
    k = (xm @ p["wk"]).reshape(b, t, nh, hp)
    v = (xm @ p["wv"]).reshape(b, t, nh, hp)
    i_g, f_g = _mlstm_gates(cfg, xm.float() @ p["wif"])
    logf = torch.log(f_g + 1e-9)

    qc = q.reshape(b, nc, q_len, nh, hp)
    kc = k.reshape(b, nc, q_len, nh, hp)
    vc = v.reshape(b, nc, q_len, nh, hp)
    ic = i_g.reshape(b, nc, q_len, nh)
    cum = torch.cumsum(logf.reshape(b, nc, q_len, nh), dim=2)

    qk = torch.einsum("bcihp,bcjhp->bcijh", qc, kc)
    kern = (qk * _decay(cum) * ic[:, :, None, :, :]).to(u.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", kern, vc)

    seg = torch.exp(cum[:, :, -1:, :] - cum)
    vw = vc * (seg * ic).to(u.dtype)[..., None]
    s_chunk = torch.einsum("bcqhp,bcqhv->bchpv", kc, vw)
    c0 = state["c"] if state is not None else \
        torch.zeros((b, nh, hp, hp), dtype=torch.float32, device=u.device)
    c_final, c_prevs = _carry(s_chunk.float(), torch.exp(cum[:, :, -1, :]),
                              c0)
    y_inter = torch.einsum("bcqhp,bchpv->bcqhv", qc, c_prevs.to(u.dtype)) \
        * torch.exp(cum).to(u.dtype)[..., None]
    y = (y_intra + y_inter).reshape(b, t, d_up)
    y = y * F.silu(z)
    return y @ p["down"], {"c": c_final}


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    d_up = cfg.ssm.expand * cfg.d_model
    nh, hp = _mlstm_heads(cfg, d_up)
    return {"c": torch.zeros((batch, nh, hp, hp), dtype=torch.float32,
                             device=device)}


def mlstm_decode(p: Params, cfg: ModelConfig, u, state):
    """u: (B, 1, D); O(1) matrix-memory update in f32."""
    b = u.shape[0]
    d_up = p["wq"].shape[0]
    nh, hp = _mlstm_heads(cfg, d_up)
    xm, z = (u @ p["up"]).chunk(2, dim=-1)
    q = (xm @ p["wq"]).reshape(b, nh, hp) / math.sqrt(hp)
    k = (xm @ p["wk"]).reshape(b, nh, hp)
    v = (xm @ p["wv"]).reshape(b, nh, hp)
    i_g, f_g = _mlstm_gates(cfg, xm[:, 0].float() @ p["wif"])
    c = state["c"] * f_g[:, :, None, None] + i_g[:, :, None, None] \
        * (k.float()[..., :, None] * v.float()[..., None, :])
    y = torch.einsum("bhp,bhpv->bhv", q.float(), c)
    y = y.reshape(b, 1, d_up).to(u.dtype) * F.silu(z)
    return y @ p["down"], {"c": c}


def init_slstm(gen: torch.Generator, cfg: ModelConfig, lead: Tuple, dtype,
               device) -> Params:
    """The sLSTM leaves of ``lead`` stacked layers: the gates' input
    projection (i, f, z, o) and the down projection (half scale) as
    ``layers.dense_init``; the block-diagonal recurrent weights ``rh``
    (H, P, 4P) at N(0, 1/P), f32 whatever the dtype."""
    d = cfg.d_model
    nh = cfg.num_heads
    hp = d // nh
    lead = tuple(lead)
    return {
        "wx": L.dense_init(gen, lead + (d, 4 * d), dtype, device),
        "rh": torch.randn(lead + (nh, hp, 4 * hp), generator=gen,
                          dtype=torch.float32, device=device)
        / math.sqrt(hp),
        "down": L.dense_init(gen, lead + (d, d), dtype, device, scale=0.5),
    }


def slstm_forward(p: Params, cfg: ModelConfig, u, state=None):
    """Strictly sequential sLSTM (a loop over time). u: (B, T, D).
    Returns (y, (c, n, h))."""
    b, t, d = u.shape
    nh = cfg.num_heads
    hp = d // nh
    gx = (u @ p["wx"]).float().reshape(b, t, nh, 4 * hp)
    if state is None:
        zeros = torch.zeros((b, nh, hp), dtype=torch.float32,
                            device=u.device)
        state = (zeros, zeros, zeros)
    c, n, h = state
    hs = []
    for s in range(t):
        g = gx[:, s] + torch.einsum("bhp,hpq->bhq", h, p["rh"])
        i, f, zg, o = g.chunk(4, dim=-1)
        i = torch.exp(torch.clamp(i, max=8.0))
        f = torch.sigmoid(f)
        c = f * c + i * torch.tanh(zg)
        n = f * n + i
        h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, t, d).to(u.dtype)
    return y @ p["down"], (c, n, h)


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    nh = cfg.num_heads
    hp = cfg.d_model // nh
    z = torch.zeros((batch, nh, hp), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone())


def slstm_decode(p: Params, cfg: ModelConfig, u, state):
    return slstm_forward(p, cfg, u, state)
