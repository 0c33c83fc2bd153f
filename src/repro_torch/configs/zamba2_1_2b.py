"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

38 Mamba2 layers with one weight-shared (attention + MLP) block applied
every 6 layers (the Zamba2 "shared transformer block" pattern).
ssm_state=64. Recurrent state makes decode O(1) in context length, so
``long_500k`` runs natively.
"""
from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family=HYBRID,
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    activation="gelu",
    ssm=SSMConfig(state_dim=64, expand=2, chunk_size=256, shared_attn_every=6),
    source="arXiv:2411.15242",
))
