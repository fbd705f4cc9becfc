"""Model zoo: family dispatch for init / forward / prefill / decode.

The port has the SSM family (Mamba2) so far; the DiT serving path uses
its modules directly.  Every other family is a later slice."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    """Return the module implementing cfg.family."""
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        return ssm
    raise NotImplementedError(
        f"the {cfg.family!r} family is a later slice of the port (only "
        f"'ssm' is ported)")
