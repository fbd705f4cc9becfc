"""gemma3-12b [dense] — hf:google/gemma-3 family.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; 5:1 local:global
interleave, 128k context.  Local layers are sliding-window (1024); every 6th
layer is global full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    local_global=(5, 1),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=131072,
)
