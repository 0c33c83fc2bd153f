"""Minitron-8B [arXiv:2407.14679]: pruned Nemotron-4, dense GQA, squared-ReLU."""
from repro_torch.configs.base import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10000.0,
    source="arXiv:2407.14679",
))
