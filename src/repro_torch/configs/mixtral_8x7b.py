"""mixtral-8x7b [moe] — arXiv:2401.04088.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; 8 experts top-2,
sliding-window attention (4096).
"""
from repro_torch.configs.base import SWA, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention=SWA,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336),
)
