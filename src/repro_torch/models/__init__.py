"""Model zoo: family dispatch for init / forward / prefill / decode.

The port has every LM family: ``ssm`` (Mamba2), ``hybrid`` (Zamba2),
``dense`` and ``moe`` (the decoder stack, with SWA, MLA and MoE blocks),
``encdec`` (Whisper) and ``vlm``; the DiT serving path uses its modules
directly.  The ``dit`` family's ``dit.forward`` is a later slice."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    """Return the module implementing cfg.family."""
    from repro_torch.models import encdec, hybrid, ssm, transformer, vlm
    family = {"dense": transformer, "moe": transformer, "ssm": ssm,
              "hybrid": hybrid, "encdec": encdec, "vlm": vlm}.get(cfg.family)
    if family is None:
        raise NotImplementedError(
            f"the {cfg.family!r} family is a later slice of the port (the "
            f"DiT's dit.forward comes with the training slice)")
    return family
