"""Nemotron-4-15B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family=DENSE,
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10000.0,
    source="arXiv:2402.16819",
))
