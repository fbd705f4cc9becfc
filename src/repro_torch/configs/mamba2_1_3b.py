"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048 attn-free vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,                 # unused for SSM
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128),
    max_seq_len=1048576,
)
