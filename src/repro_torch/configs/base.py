"""Config system: model architecture configs + input shapes.

Every assigned architecture is a ``ModelConfig``; reduced variants for
CPU smoke tests come from ``ModelConfig.reduced()``. Input shapes are
``InputShape`` entries in ``INPUT_SHAPES``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"            # decoder-only, full attention
MOE = "moe"                # decoder-only, mixture-of-experts MLP
SSM = "ssm"                # recurrent (xLSTM: sLSTM + mLSTM blocks)
HYBRID = "hybrid"          # Mamba2 backbone + shared attention blocks
ENCDEC = "encdec"          # encoder-decoder (audio backbone)
VLM = "vlm"                # decoder-only + interleaved cross-attn layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # d_ff of each expert (may differ from the dense d_ff)
    expert_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # Mamba2 / mLSTM state size
    conv_dim: int = 4
    expand: int = 2
    chunk_size: int = 256         # chunked-scan block
    # zamba2: one shared attention block applied every k layers
    shared_attn_every: int = 0    # 0 = no attention blocks
    # xlstm: pattern of block kinds, cycled over layers
    block_pattern: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // num_heads
    # attention behaviour
    attention_window: int = 0             # 0 = full attention; >0 = sliding window
    qkv_bias: bool = False
    activation: str = "silu"              # silu | squared_relu | gelu
    rope_theta: float = 500000.0
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec: encoder stack depth (decoder uses num_layers)
    encoder_layers: int = 0
    # VLM: a cross-attention layer every N layers (0 = none)
    cross_attn_every: int = 0
    # frontend stub: embedding dim + #frames/patches supplied by input_specs()
    frontend_tokens: int = 0              # e.g. audio frames or image patches
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # "" = cache in model dtype; "int8" = symmetric per-(seq,head)
    # quantized KV cache (beyond-paper serving optimization, §Perf).
    kv_cache_dtype: str = ""
    source: str = ""                      # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per token per sequence (paper §2.2 analog)."""
        if self.family == SSM:
            return 0  # recurrent state is O(1) in seq len
        if self.mla is not None:
            per_layer = self.mla.kv_lora_rank + self.mla.rope_head_dim
        else:
            per_layer = 2 * self.num_kv_heads * self.resolved_head_dim
        layers = self.num_layers
        if self.family == HYBRID and self.ssm and self.ssm.shared_attn_every:
            layers = self.num_layers // self.ssm.shared_attn_every
        return layers * per_layer * bytes_per_el

    def num_params(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            attn = (d * m.kv_lora_rank + d * m.rope_head_dim
                    + m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                    + d * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        else:
            attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d)
        act_mult = 2 if self.activation == "squared_relu" else 3
        if self.moe is not None:
            eff = self.moe.expert_d_ff or self.d_ff
            mlp = ((self.moe.num_experts + self.moe.num_shared_experts)
                   * act_mult * d * eff)
            mlp += d * self.moe.num_experts  # router
        else:
            mlp = act_mult * d * self.d_ff
        if self.family == SSM:
            # xlstm-ish: qkv + gates + out per block, no separate MLP
            inner = self.ssm.expand * d if self.ssm else 2 * d
            mlp = 0
            attn = 4 * d * inner + inner * d
        if self.family == HYBRID:
            inner = self.ssm.expand * d if self.ssm else 2 * d
            state = self.ssm.state_dim if self.ssm else 64
            mamba = 2 * d * inner + inner * d + inner * state
            attn = mamba  # per-layer mamba cost; shared attn counted once below
            mlp = 0       # hybrid layers are Mamba-only; MLP lives in the shared block
        body = L * (attn + mlp)
        if self.family == HYBRID and self.ssm and self.ssm.shared_attn_every:
            body += (d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
                     + 2 * d * self.d_ff)  # one shared block's params
        if self.encoder_layers:
            body += self.encoder_layers * (attn + mlp)
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            body += n_cross * (2 * d * self.num_kv_heads * hd + d * self.num_heads * hd
                               + self.num_heads * hd * d)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return body + emb

    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.num_params()
        total = self.num_params()
        d = self.d_model
        act_mult = 2 if self.activation == "squared_relu" else 3
        eff = self.moe.expert_d_ff or self.d_ff
        n_exp = self.moe.num_experts + self.moe.num_shared_experts
        all_exp = self.num_layers * n_exp * act_mult * d * eff
        n_act = self.moe.top_k + self.moe.num_shared_experts
        active_exp = self.num_layers * n_act * act_mult * d * eff
        return total - all_exp + active_exp

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 1024),
        )
        nh = max(2, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        kw["num_heads"], kw["num_kv_heads"] = nh, nkv
        kw["head_dim"] = 64 if self.head_dim else 0
        kw["d_ff"] = min(self.d_ff, 512) if self.d_ff else 0
        kw["frontend_tokens"] = min(self.frontend_tokens, 16) \
            if self.frontend_tokens else 0
        kw["encoder_layers"] = 2 if self.encoder_layers else 0
        kw["cross_attn_every"] = 2 if self.cross_attn_every else 0
        kw["attention_window"] = min(self.attention_window, 64) \
            if self.attention_window else 0
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=(min(self.moe.expert_d_ff, 256)
                             if self.moe.expert_d_ff else 0),
            )
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32)
            kw["head_dim"] = 0
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16),
                chunk_size=32,
                # keep the shared-attn block exercised in the reduced model
                shared_attn_every=2 if self.ssm.shared_attn_every else 0)
            if self.ssm.block_pattern:
                # at least one full block-pattern group
                kw["num_layers"] = len(self.ssm.block_pattern)
            elif self.ssm.shared_attn_every:
                kw["num_layers"] = 3      # 1 group of 2 + 1 remainder layer
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    # import registers
    from repro_torch.configs import (  # noqa: F401
        seamless_m4t_large_v2, nemotron_4_340b, minitron_8b, qwen1_5_32b,
        llama4_scout_17b_a16e, zamba2_1_2b, deepseek_v2_236b, nemotron_4_15b,
        xlstm_350m, llama_3_2_vision_11b, llama3_70b)
