"""Model zoo: family dispatch for init / forward / prefill / decode.

The port has the ``ssm`` (Mamba2), ``hybrid`` (Zamba2), ``dense``
(dense and local:global SWA) and ``vlm`` families; the DiT serving path
uses its modules directly.  ``moe`` and ``encdec`` (and the DiT's
``dit.forward``) are later slices."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    """Return the module implementing cfg.family."""
    from repro_torch.models import hybrid, ssm, transformer, vlm
    family = {"dense": transformer, "ssm": ssm, "hybrid": hybrid,
              "vlm": vlm}.get(cfg.family)
    if family is None:
        raise NotImplementedError(
            f"the {cfg.family!r} family is a later slice of the port (the "
            f"next one: MoE, MLA, encdec; ported: dense, hybrid, ssm, vlm)")
    return family
