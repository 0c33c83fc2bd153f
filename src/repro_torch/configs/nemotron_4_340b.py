"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family=DENSE,
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10000.0,
    source="arXiv:2402.16819",
))
