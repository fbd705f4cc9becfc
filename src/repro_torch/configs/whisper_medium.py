"""whisper-medium [audio] — arXiv:2212.04356 (enc-dec).

Backbone only: 24L (x2: encoder+decoder) d_model=1024 16H d_ff=4096
vocab=51865.  The conv audio frontend is a STUB — `input_specs()` provides
precomputed frame embeddings (1500 frames of d_model).
"""
from repro_torch.configs.base import FULL, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    attention=FULL,
    frontend="audio_frames",
    frontend_seq=1500,
)
