"""Model zoo: family dispatch for init / forward / prefill / decode.

The port has every family: ``ssm`` (Mamba2), ``hybrid`` (Zamba2),
``dense`` and ``moe`` (the decoder stack, with SWA, MLA and MoE blocks),
``encdec`` (Whisper), ``vlm`` and ``dit`` (``dit.forward``, the
flow-matching trainer's; the DiT serving path uses ``dit``'s modules
directly)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    """Return the module implementing cfg.family."""
    from repro_torch.models import dit, encdec, hybrid, ssm, transformer, vlm
    return {"dense": transformer, "moe": transformer, "ssm": ssm,
            "hybrid": hybrid, "encdec": encdec, "vlm": vlm,
            "dit": dit}[cfg.family]
