from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      SSMConfig, DiTConfig)
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "DiTConfig",
    "DIT_IMAGE", "DIT_VIDEO",
]
