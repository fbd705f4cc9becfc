"""The DiT's loss over its first AdamW steps: JAX's ``make_train_step``
against the port's, on the CPU, from the same livened weights and batch.

    PYTHONPATH=src python tests/dit_lr_witness.py [--layers 10] [--lr 3e-4]

At DIT_IMAGE's full width (d_model 1536) and lr 3e-4 the loss rises
after the first step, the more so the deeper the model.  The script runs
DIT_IMAGE at its full width with the depth and the latent cut (16 x 16
latents, 64 tokens a sample, batch 2, 64 text tokens; 5 steps; about
16 GiB and 80 s at 10 layers), both packages from
one set of weights (JAX's init, its adaLN-Zero leaves livened by
``liven``, carried to the port by ``convert.load_jax_params``) and one
numpy batch, and prints each package's loss per step and their largest
relative difference.  A fault of the port would show as a trajectory of
its own; the same rise on both sides is the arithmetic of the step.
``tests/test_torch_training.py`` runs it at the reduced width.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import resource
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import dit as jdit
from repro.models import layers as jL
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import DIT_IMAGE
from repro_torch.convert import load_jax_params
from repro_torch.models import dit
from repro_torch.training import optimizer, train_loop

HW, STEPS = 16, 5
LIVENED = ("ada_w", "ada_b", "final_ada_w", "final_ada_b", "final_out")


def liven(params: dict, d_model: int, seed: int = 123,
          scale: float = 0.05) -> None:
    """``dit.liven_adaln``'s draws (scale (128 / d_model)^1/2 x 0.05), from
    numpy, in place in JAX's tree: the stacked blocks' ``ada_w``/``ada_b``
    and the final adaLN and output head."""
    rng = np.random.default_rng(seed)
    scale = scale * math.sqrt(128 / d_model)
    for tree in (params["blocks"], params):
        for name in LIVENED:
            if name in tree:
                tree[name] = jax.numpy.asarray(scale * rng.standard_normal(
                    tree[name].shape).astype(np.float32))


def make_batch(cfg, hw: int, batch: int = 2, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    shape = (batch, 1, hw, hw, cfg.dit.in_channels)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32),
            "t": rng.uniform(0, 1000, (batch,)).astype(np.float32),
            "txt": rng.standard_normal((batch, 64, cfg.dit.cond_dim))
            .astype(np.float32)}


def trajectories(jcfg, cfg, *, steps: int, lr: float, hw: int):
    """Each package's loss and grad norm per step, bf16 forward (as both
    ``loss_fn``s run it), AdamW at ``lr``, ``steps`` steps on one batch."""
    params, _ = jL.split_params(jdit.init(jax.random.PRNGKey(0), jcfg))
    liven(params, jcfg.d_model)
    model = dit.init(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    batch = make_batch(cfg, hw)

    jstep = jax.jit(jtl.make_train_step(jcfg, remat="none", lr=lr),
                    donate_argnums=(0, 1))
    jopt_state = jopt.adamw_init(params)
    want = []
    for _ in range(steps):
        params, jopt_state, m = jstep(params, jopt_state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    del params, jopt_state

    step = train_loop.make_train_step(cfg, remat="none", lr=lr)
    opt = optimizer.adamw_init(dict(model.named_parameters()))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(steps):
        model, opt, m = step(model, opt, tb)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return want, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    jcfg = dataclasses.replace(jax_get_config("dit-image"),
                               num_layers=args.layers)
    cfg = dataclasses.replace(DIT_IMAGE, num_layers=args.layers)
    t0 = time.time()
    want, got = trajectories(jcfg, cfg, steps=STEPS, lr=args.lr, hw=HW)
    print(f"DIT_IMAGE d_model {cfg.d_model}, {args.layers} layers, "
          f"{(HW // cfg.dit.patch_size) ** 2} tokens x 2, lr {args.lr}")
    print(" step   JAX loss  port loss   JAX gnorm  port gnorm")
    for i, ((jl, jg), (pl, pg)) in enumerate(zip(want, got)):
        print(f" {i + 1:4d} {jl:10.5f} {pl:10.5f} {jg:11.5f} {pg:11.5f}")
    worst = max(abs(p - j) / abs(j) for (j, _), (p, _) in zip(want, got))
    print(f"largest relative loss difference {worst:.3e}; "
          f"{time.time() - t0:.0f} s, peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
          f" GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
