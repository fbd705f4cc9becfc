"""Fault tolerance and straggler mitigation for training
(``repro/training/fault_tolerance.py`` in PyTorch).

* ``ResilientTrainer`` wraps the train loop with checkpoint-every-K and a
  crash/restore path: on restart it restores the latest atomic
  checkpoint and the data pipeline's cursor, so the run resumes the
  exact stream.  The state is ``(module, opt_state)``: the step updates
  the module's parameters in place, so ``init_state`` must build a fresh
  one each call.  A checkpoint holds ``(parameters by name, opt_state)``.
  ``run(..., shardings=)`` restores onto a mesh (an elastic restart onto
  the surviving ranks): a tree of that structure with
  :class:`repro_torch.sharding.NamedSharding` leaves, as
  :meth:`CheckpointManager.restore` takes it; the restored ``DTensor``
  values are copied into the fresh state's ``DTensor`` parameters.
* ``StragglerMonitor`` implements cost-model-based timeout + skip-and-
  rescale: a data-parallel gradient bucket that misses the deadline is
  dropped and the remaining gradients are averaged over the workers that
  answered.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.training.checkpoint import CheckpointManager


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts,
    lists and tuples; anything else is a leaf): ``jax.tree.map``'s role."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


@dataclass
class StragglerMonitor:
    """Per-step contribution timeout with skip-and-rescale semantics."""
    world: int
    timeout_factor: float = 3.0         # x median step time
    history: list = field(default_factory=list)
    skipped: int = 0

    def deadline(self) -> float:
        if not self.history:
            return float("inf")
        med = sorted(self.history)[len(self.history) // 2]
        return med * self.timeout_factor

    def observe(self, seconds: float):
        self.history.append(seconds)
        if len(self.history) > 64:
            self.history.pop(0)

    def aggregate(self, grads_per_worker: list[Optional[Any]]) -> Any:
        """Average gradients, skipping stragglers (None) and rescaling."""
        alive = [g for g in grads_per_worker if g is not None]
        self.skipped += len(grads_per_worker) - len(alive)
        if not alive:
            raise RuntimeError("all workers straggled")
        scale = 1.0 / len(alive)
        return tree_map(lambda *gs: sum(gs) * scale, *alive)


def _tree(state):
    """The checkpointed form of ``(module, opt_state)``."""
    module, opt = state
    return dict(module.named_parameters()), opt


class ResilientTrainer:
    """Checkpoint-every-K training wrapper with restart."""

    def __init__(self, ckpt_dir, train_step: Callable, init_state: Callable,
                 *, save_every: int = 10, keep: int = 2,
                 async_save: bool = True):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep,
                                     async_save=async_save)
        self.train_step = train_step
        self.init_state = init_state
        self.save_every = save_every

    # ------------------------------------------------------------------
    def run(self, pipeline, num_steps: int, *,
            crash_at: Optional[int] = None, shardings: Any = None) -> dict:
        """Train for `num_steps`; optionally simulate a crash (raises) to
        exercise the restart path.  Returns final state + metrics."""
        state = self.init_state()
        start = 0
        latest = self.mgr.latest_step()
        if latest is not None:
            (params, opt), meta = self.mgr.restore(_tree(state), latest,
                                                   shardings=shardings)
            named = dict(state[0].named_parameters())
            with torch.no_grad():
                for name, value in params.items():
                    named[name].copy_(value)
            state = (state[0], opt)
            start = meta["step"]
            pipeline.seek(meta["extra"].get("data_cursor", start))
        metrics = {}
        for step in range(start, num_steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"simulated crash at step {step}")
            batch = next(pipeline)
            state, metrics = self._step(state, batch)
            if (step + 1) % self.save_every == 0 or step + 1 == num_steps:
                self.mgr.save(step + 1, _tree(state),
                              extra={"data_cursor": pipeline.cursor(),
                                     "loss": float(metrics.get("loss", 0))})
        self.mgr.wait()
        return {"state": state, "metrics": metrics,
                "final_step": num_steps}

    def _step(self, state, batch):
        module, opt = state
        module, opt, metrics = self.train_step(module, opt, batch)
        return (module, opt), metrics
