"""SeamlessM4T-Large v2 text/speech backbone [arXiv:2308.11596].

[audio] enc-dec, multimodal. 24L per stack (the v2 model has a 24-layer
speech encoder and 24-layer text decoder; see DESIGN.md §6),
d_model=1024, 16H (GQA kv=16 == MHA), d_ff=8192, vocab=256206.
The mel-spectrogram + conv feature-extractor frontend is STUBBED:
``input_specs()`` supplies precomputed frame embeddings.
"""
from repro_torch.configs.base import ENCDEC, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family=ENCDEC,
    num_layers=24,            # decoder stack
    encoder_layers=24,        # speech-encoder stack (consumes frame embeddings)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    activation="silu",
    frontend_tokens=1024,     # precomputed audio frame embeddings per request
    source="arXiv:2308.11596",
))
