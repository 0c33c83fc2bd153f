"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks, no separate MLP.

d_ff=0: xLSTM blocks carry their own up/down projections
(post-up-projection mLSTM, pre-up-projection sLSTM). Block pattern is
the paper's mostly-mLSTM mix with an sLSTM block every 4th layer.
Recurrent (matrix-memory) state ⇒ decode is O(1) in context length, so
``long_500k`` runs natively.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family=SSM,
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    activation="gelu",
    ssm=SSMConfig(state_dim=64, expand=2, chunk_size=256,
                  block_pattern=("mlstm", "mlstm", "mlstm", "slstm")),
    source="arXiv:2405.04517",
))
