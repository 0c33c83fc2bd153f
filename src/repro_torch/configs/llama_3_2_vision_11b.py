"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision].

[vlm] 40L decoder with a cross-attention (image) layer every 5th layer.
The ViT vision encoder + projector frontend is STUBBED: ``input_specs()``
supplies precomputed patch embeddings (1601 patches -> projected).
"""
from repro_torch.configs.base import VLM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family=VLM,
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="silu",
    rope_theta=500000.0,
    cross_attn_every=5,
    frontend_tokens=1601,     # precomputed vision patch embeddings
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
