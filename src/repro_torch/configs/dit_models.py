"""The paper's own model family: latent diffusion transformers.

Two serving models mirroring the paper's evaluation:
  * ``dit-image``  — Qwen-Image-analogue image DiT (paper §6.1)
  * ``dit-video``  — Wan2.2-5B-analogue video DiT  (paper §6.1)

Request classes (paper §6.1):
  Wan2.2  S/M/L: 480x832x49f / 480x832x81f / 720x1280x81f videos
  Qwen-Image S/M/L: 512/1024/1536 px images
"""
from repro_torch.configs.base import DiTConfig, FULL, ModelConfig

# Image DiT — MM-DiT-style backbone sized near Qwen-Image-lite scale.
DIT_IMAGE = ModelConfig(
    name="dit-image",
    family="dit",
    num_layers=28,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=0,
    attention=FULL,
    dit=DiTConfig(patch_size=2, in_channels=16, cond_dim=1024, num_steps=50),
)

# Video DiT — Wan-style 3D-latent backbone.
DIT_VIDEO = ModelConfig(
    name="dit-video",
    family="dit",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=24,
    head_dim=128,
    d_ff=12288,
    vocab_size=0,
    attention=FULL,
    dit=DiTConfig(patch_size=2, in_channels=16, cond_dim=1024, num_steps=50,
                  latent_frames=21),
)
