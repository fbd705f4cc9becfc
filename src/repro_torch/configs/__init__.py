from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      SSMConfig, DiTConfig, ShapeCell, SHAPES,
                                      cell_is_applicable)
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config, list_archs

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "DiTConfig",
    "ShapeCell", "SHAPES", "cell_is_applicable", "ASSIGNED_ARCHS",
    "get_config", "list_archs", "DIT_IMAGE", "DIT_VIDEO",
]
