"""Command-line trainer (the port's twin of ``examples/train_lm.py``): train
the example's reduced LM (8.1M parameters), or a reduced DiT-image on
the flow-matching loss, with the full substrate: the token pipeline,
AdamW, atomic async checkpoints.

    python -m repro_torch.training.train_lm [--device cpu] [--steps N]
        [--arch yi-6b|dit-image|...]

It runs on the card unless given ``--device cpu``; checkpoints go under
``build/train_lm`` of the checkout unless ``--ckpt`` says otherwise.
An LM reads a fresh ``TokenPipeline`` batch of 8 x 128 tokens each
step; the DiT trains on one seeded synthetic batch of 2 (random latents
carry nothing to learn across batches).  As the JAX example, it exits
non-zero if the last step's loss is not below the first's: an LM on
random tokens needs its 200 steps for that, the DiT falls at every step.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.models import dit, get_model
from repro_torch.models.layers import resolve_device
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import TokenPipeline
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step, synth_batch

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_lm"
BATCH, SEQ = 8, 128                  # the JAX example's
DIT_BATCH = 2


def reduced_config(arch: str):
    """The model it trains: the JAX example's reduced LM width, or
    DIT_IMAGE.reduced() at four layers."""
    cfg = get_config(arch)
    if cfg.family == "dit":
        return cfg.reduced(num_layers=4)
    return cfg.reduced(num_layers=4, d_model=256, num_heads=8,
                       num_kv_heads=4, head_dim=32, d_ff=1024,
                       vocab_size=8192)


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    model = get_model(cfg).init(cfg, device=device)
    if cfg.family == "dit":
        dit.liven_adaln(model, cfg.d_model)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} reduced: {n_params / 1e6:.1f}M params on "
          f"{device}")

    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat="none", lr=3e-4)
    pipe = None
    tokens = BATCH * SEQ
    if cfg.family == "dit":
        fixed = synth_batch(cfg, DIT_BATCH, SEQ, device=device)
        b, f, h, w, _ = fixed["latents"].shape
        tokens = b * f * (h // cfg.dit.patch_size) * (w // cfg.dit.patch_size)
    else:
        pipe = TokenPipeline(cfg, batch=BATCH, seq=SEQ, seed=0)
    mgr = CheckpointManager(args.ckpt, keep=2, async_save=True)

    losses = []
    every = max(1, min(20, args.steps // 10))
    t0 = time.time()
    for step in range(args.steps):
        batch = fixed if pipe is None else _to(next(pipe), device)
        model, opt, metrics = step_fn(model, opt, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % every == 0:
            rate = (step + 1) * tokens / (time.time() - t0)
            print(f"step {step + 1:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{rate:,.0f} tok/s", flush=True)
        if (step + 1) % 50 == 0 or step + 1 == args.steps:
            mgr.save(step + 1, (dict(model.named_parameters()), opt),
                     extra={"data_cursor": (step + 1 if pipe is None
                                            else pipe.cursor())})
    mgr.wait()
    if pipe is not None:
        pipe.close()
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; checkpoints at "
          f"{args.ckpt}: steps {sorted(mgr.steps())}")
    if not losses[-1] < losses[0]:
        print("loss did not improve")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
