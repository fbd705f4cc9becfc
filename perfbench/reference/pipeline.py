"""A served request, recomputed by the plain reference: text encoder,
the denoise steps (one DiT forward and one flow step each), VAE decode.

``params`` maps ``"dit"``, ``"txt"`` and ``"vae"`` to the parameter
dicts of :mod:`dit`, :mod:`text_encoder` and :mod:`vae`; ``sizes`` is a
configuration file's dict (its ``model``, ``text_encoder`` and ``vae``
sections)."""
from __future__ import annotations

import torch

from perfbench.reference import dit, flow, text_encoder, vae
from perfbench.reference.arith import Arith


def latent_shape(sizes: dict, height: int, width: int,
                 frames: int) -> tuple[int, int, int, int]:
    """(F, H, W, C) of the latent: 8x spatial and 4x temporal downsample."""
    f = max(1, (frames + 3) // 4) if frames > 1 else 1
    return f, height // 8, width // 8, sizes["model"]["in_channels"]


def token_count(sizes: dict, height: int, width: int, frames: int) -> int:
    f, h, w, _ = latent_shape(sizes, height, width, frames)
    p = sizes["model"]["patch_size"]
    return f * (h // p) * (w // p)


def patch_dim(sizes: dict) -> int:
    m = sizes["model"]
    return m["patch_size"] ** 2 * m["in_channels"]


def embeds(params: dict, sizes: dict, request_id: str, device,
           ar: Arith = Arith()):
    """(77, cond_dim) text embeddings of the request's prompt."""
    tok = flow.prompt_tokens(request_id, sizes["text_encoder"]["vocab"])
    return text_encoder.encode(params["txt"], tok.to(device),
                               sizes["text_encoder"], ar)[0]


def step(params: dict, sizes: dict, x, emb, num_steps: int, index: int,
         ar: Arith = Arith()):
    """Denoise step ``index`` of ``num_steps`` on the latent tokens
    ``x`` (N, patch_dim): one forward, one Euler step."""
    s_now, s_next = flow.sigma_pair(num_steps, index)
    t = torch.tensor([flow.timestep(s_now)], dtype=torch.float32,
                     device=x.device)
    v = dit.forward(params["dit"], x[None], t, emb[None], sizes["model"],
                    ar)[0]
    return flow.flow_step(x, v, s_now, s_next)


def decode(params: dict, sizes: dict, x, shape, ar: Arith = Arith()):
    """Pixels (F, 8H, 8W, 3) of the latent tokens ``x`` of ``shape``."""
    lat = dit.unpatchify(x[None], (1, *shape), sizes["model"]["patch_size"])
    return vae.decode(params["vae"], lat, ar)[0]


def serve(params: dict, sizes: dict, request_id: str, height: int,
          width: int, frames: int, num_steps: int, device,
          ar: Arith = Arith()) -> dict:
    """Every output of a whole request: ``embeds``, ``latent`` (after
    the last step) and ``pixels``."""
    shape = latent_shape(sizes, height, width, frames)
    emb = embeds(params, sizes, request_id, device, ar)
    x = flow.initial_latent(request_id, token_count(sizes, height, width,
                                                    frames),
                            patch_dim(sizes), num_steps).to(device)
    for i in range(num_steps):
        x = step(params, sizes, x, emb, num_steps, i, ar)
    return {"embeds": emb, "latent": x,
            "pixels": decode(params, sizes, x, shape, ar)}
