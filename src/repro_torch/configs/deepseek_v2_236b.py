"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA + fine-grained MoE.

MLA with kv_lora_rank=512 (compressed KV cache: 512+64 floats/token/layer
instead of 2*128*128). MoE: 160 routed experts top-6 + 2 shared experts,
expert d_ff=1536. (The real model's first layer is a dense MLP; we keep
a uniform MoE stack — noted in DESIGN.md §6.)
"""
from repro_torch.configs.base import MOE, MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family=MOE,
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    activation="silu",
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  expert_d_ff=1536),
    source="arXiv:2405.04434",
))
