"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: dense, QKV bias, full MHA KV."""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family=DENSE,
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu",
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
))
