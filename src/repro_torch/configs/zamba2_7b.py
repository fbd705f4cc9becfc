"""zamba2-7b [hybrid] — arXiv:2411.15242 (Mamba2 + shared attention blocks).

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
A single SHARED attention block (params reused) is applied every 6 mamba
layers.
"""
from repro_torch.configs.base import FULL, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    attention=FULL,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=128),
    shared_attn_every=6,
)
