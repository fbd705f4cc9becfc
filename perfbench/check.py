"""How ``correct`` is decided: what the timed path produced, against the
plain reference recomputed from the same seed.

Two modes, by the traffic mix's ``check.mode``:

* ``requests``: a sample of the window's finished requests, drawn from
  the seed, holding the longest request and (where there was one) a
  request served in a pack.  Each is recomputed whole by the reference
  (text encoder, every denoise step, VAE decode); compared are the text
  embeddings, the latent after the last step, and the pixels.
* ``steps``: requests that outlast the window.  Compared are the text
  embeddings and the updates of denoise steps: step 0 from the
  request's own start (the reference from its own inputs), and the
  window's last step with ``window_steps`` more of the window's steps
  drawn from the seed, each from the program's latent before it (the
  reference follows the program from the program's own state there).
  A step's update is its output minus its input; one step of 50 moves
  the latent by well under a tenth of its norm, so the update is what
  tells a step's arithmetic apart.  ``stepk_rel_l2`` is the worst of
  the window's steps compared.

Each number is the relative L2 distance ``|prog - ref| / |ref|``, the
largest over the compared requests, held to the configuration's
``limits`` for the mode.
"""
from __future__ import annotations

import random

import torch

from perfbench.reference import flow, pipeline
from perfbench.reference.arith import Arith


def rel_l2(got, ref) -> float:
    got = torch.as_tensor(got, device=ref.device).double()
    ref = ref.double()
    return float((got - ref).norm() / ref.norm())


def sample(finished: list, tokens: dict, packed: set, n: int,
           seed: int) -> list:
    """n of the ``finished`` request ids, drawn from the seed: the
    longest (most tokens; the first such id), one served in a pack if
    any, the rest at random."""
    ids = sorted(finished)
    if not ids:
        return []
    longest = max(ids, key=lambda r: (tokens[r], r))
    rng = random.Random(seed * 7919 + 17)
    picked = [longest]
    in_pack = [r for r in ids if r in packed and r != longest]
    if in_pack:
        picked.append(rng.choice(in_pack))
    rest = [r for r in ids if r not in picked]
    rng.shuffle(rest)
    return picked + rest[:max(0, n - len(picked))]


def reference_request(params, sizes, spec, device, ar: Arith) -> dict:
    """The reference's outputs of a whole request (``requests`` mode)."""
    return pipeline.serve(params, sizes, spec.id, spec.height, spec.width,
                          spec.frames, spec.steps, device, ar)


def initial(sizes, spec, device):
    """The request's own starting latent."""
    return flow.initial_latent(spec.id, spec.tokens, pipeline.patch_dim(sizes),
                               spec.steps).to(device)


def sample_steps(indices: list, n: int, seed: int) -> list:
    """The last of the window's step ``indices`` and ``n`` more drawn
    from the seed, in order."""
    if not indices:
        return []
    last, rest = indices[-1], list(indices[:-1])
    random.Random(seed * 7919 + 29).shuffle(rest)
    return sorted([last, *rest[:n]])


def reference_steps(params, sizes, spec, window: list, device,
                    ar: Arith) -> dict:
    """The reference's embeddings, latent after step 0, and for each
    ``(k, x_in)`` of ``window`` the latent after step k from ``x_in``
    (``steps`` mode)."""
    emb = pipeline.embeds(params, sizes, spec.id, device, ar)
    step0 = pipeline.step(params, sizes, initial(sizes, spec, device), emb,
                          spec.steps, 0, ar)
    out = []
    for k, x_in in window:
        xk = torch.as_tensor(x_in, device=device).float()
        out.append(pipeline.step(params, sizes, xk, emb, spec.steps, k, ar))
    return {"embeds": emb, "step0": step0, "window": out}


def steps_numbers(got: dict, ref: dict, x0) -> dict[str, float]:
    """``steps`` mode's numbers: embeddings, the update of step 0 (from
    ``x0``) and the worst update of the window's steps compared (each
    from its own input)."""
    def update(out, x):
        return torch.as_tensor(out, device=x.device).float() - x

    def x_in(x):
        return torch.as_tensor(x, device=x0.device).float()
    stepk = [rel_l2(update(out, x_in(x)), update(r, x_in(x)))
             for (_, x, out), r in zip(got["window"], ref["window"])]
    return {"embeds_rel_l2": rel_l2(got["embeds"], ref["embeds"]),
            "step0_rel_l2": rel_l2(update(got["step0"], x0),
                                   update(ref["step0"], x0)),
            "stepk_rel_l2": max(stepk, default=float("nan"))}


def requests_numbers(got: dict, ref: dict) -> dict[str, float]:
    """``requests`` mode's numbers: embeddings, final latent, pixels."""
    return {f"{k}_rel_l2": rel_l2(got[k], ref[k])
            for k in ("embeds", "latent", "pixels")}


@torch.no_grad()
def compare(mode: str, params, sizes, programs: list, device,
            ar: Arith = Arith()) -> dict[str, float]:
    """Largest relative L2 distance of each output of ``programs`` (one
    dict a request: ``spec`` and the program's outputs) from the
    reference's."""
    worst: dict[str, float] = {}
    for prog in programs:
        spec = prog["spec"]
        if mode == "requests":
            ref = reference_request(params, sizes, spec, device, ar)
            numbers = requests_numbers(prog, ref)
        else:
            ref = reference_steps(params, sizes, spec,
                                  [(k, x) for k, x, _ in prog["window"]],
                                  device, ar)
            numbers = steps_numbers(prog, ref, initial(sizes, spec, device))
        for name, d in numbers.items():
            worst[name] = max(worst.get(name, 0.0), d)
        del ref
    return worst


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number present, finite and within its limit."""
    return bool(numbers) and all(
        name in numbers and numbers[name] == numbers[name]
        and numbers[name] <= lim for name, lim in limits.items())
