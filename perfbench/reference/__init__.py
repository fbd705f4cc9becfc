"""The benchmark's plain reference: float32 PyTorch with TF32 off, no
kernel, cache or batching, and nothing imported from the program."""
from __future__ import annotations

from perfbench.reference import dit, text_encoder, vae


def param_specs(sizes: dict) -> dict[str, dict]:
    """Parameter specs of the served pipeline by module (``dit``,
    ``txt``, ``vae``) for a configuration file's ``sizes``."""
    return {"dit": dit.param_specs(sizes["model"]),
            "txt": text_encoder.param_specs(sizes["text_encoder"]),
            "vae": vae.param_specs(dict(sizes["vae"],
                                        in_channels=sizes["model"]
                                        ["in_channels"]))}
