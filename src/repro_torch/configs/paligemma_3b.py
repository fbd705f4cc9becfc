"""paligemma-3b [vlm] — arXiv:2407.07726 (SigLIP + gemma backbone).

Transformer BACKBONE only: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216.  The SigLIP vision frontend is a STUB — `input_specs()`
provides precomputed patch embeddings (256 tokens of d_model).
"""
from repro_torch.configs.base import FULL, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    attention=FULL,
    frontend="image_patches",
    frontend_seq=256,            # 16x16 patches at 224px
    tie_embeddings=True,
)
