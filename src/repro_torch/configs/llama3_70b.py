"""Llama-3-70B — the paper's own serving model (§2.2, §7.1).

KV cache grows at 320 KB/token in fp16 across 80 layers
(2 * 8 kv-heads * 128 head_dim * 2 bytes * 80 layers = 327,680 B).
Used by the FleetOpt evaluation configs and the cost-cliff tables.
"""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-70b",
    family=DENSE,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    activation="silu",
    rope_theta=500000.0,
    source="paper §7.1 / hf:meta-llama/Meta-Llama-3-70B",
))
