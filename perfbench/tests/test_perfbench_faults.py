"""The comparison that decides ``correct`` catches a broken timed path:
a run of each tiny cell, the harness's look for a chip skipped, with the
program broken underneath, comes out not correct.  (The cells run on one
chip, so there is no exchange between chips to leave out.)"""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness


def _unchanged_state(monkeypatch):
    """Every denoise step returns its state unchanged."""
    from repro_torch.diffusion import schedule
    monkeypatch.setattr(schedule, "flow_step", lambda x, v, a, b: x)


def _half_the_batch(monkeypatch):
    """A pack's forward computes half of its members; the others get the
    mean of those."""
    from repro_torch.diffusion import pipeline
    forward = pipeline.dit.forward_sp_tokens

    def half(model, x, t, txt, cfg, **kw):
        b = x.shape[0]
        if b == 1:
            return forward(model, x, t, txt, cfg, **kw)
        k = (b + 1) // 2
        v = forward(model, x[:k], t[:k], txt[:k], cfg, **kw)
        return torch.cat([v, v.mean(0, keepdim=True).expand(b - k, *v.shape[1:])])
    monkeypatch.setattr(pipeline.dit, "forward_sp_tokens", half)


def _altered_answer(monkeypatch):
    """One value of every image altered where the decoder produces it."""
    from repro_torch.diffusion import pipeline
    decode = pipeline.vae.decode

    def altered(model, lat, cfg):
        out = decode(model, lat, cfg).clone()
        out[..., 0, 0, 0, 0] += 0.5
        return out
    monkeypatch.setattr(pipeline.vae, "decode", altered)


@pytest.mark.parametrize("workload,seconds,fault", [
    ("tiny-interactive", 2.0, _unchanged_state),
    ("tiny-closed", 0.3, _unchanged_state),
    ("tiny-backlog", 2.0, _half_the_batch),
    ("tiny-interactive", 2.0, _altered_answer),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, seconds,
                              fault):
    fault(monkeypatch)
    res = harness.run(tiny_root, workload, 2 ** 31 + 99, seconds, False,
                      time.monotonic(), device="cpu", log=lambda *a, **k: 0)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values()
               if c["value"] is not None)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 2 ** 33 + 3])
def test_window_steps_sampled_from_the_seed(seed):
    """``steps`` mode compares the window's last step and steps drawn
    from the seed; over seeds every step of the window is drawn."""
    from perfbench import check
    window = list(range(3, 11))
    picked = check.sample_steps(window, 2, seed)
    assert picked == check.sample_steps(window, 2, seed)
    assert len(picked) == 3 and picked[-1] == 10
    assert set(picked) <= set(window) and picked == sorted(picked)
    drawn = {k for s in range(seed, seed + 40)
             for k in check.sample_steps(window, 2, s)}
    assert drawn == set(window)
    assert check.sample_steps([7], 2, seed) == [7]
    assert check.sample_steps([], 2, seed) == []


def test_a_fault_in_one_window_step_is_seen(tiny_root, monkeypatch):
    """Odd steps return their state unchanged (step 0 and the window's
    last step may be sound); a run that draws an odd step of the window
    other than its last comes out not correct."""
    from perfbench import check
    from perfbench.reference import flow
    from repro_torch.diffusion import schedule
    step = schedule.flow_step
    odd = {float(s) for s in flow.flow_sigmas(50)[1::2]}
    monkeypatch.setattr(schedule, "flow_step", lambda x, v, a, b:
                        x if float(a) in odd else step(x, v, a, b))
    picked = []

    def first_odd(indices, n, seed):
        picked[:] = [k for k in indices[:-1] if k % 2][:1]
        return picked
    monkeypatch.setattr(check, "sample_steps", first_odd)
    res = harness.run(tiny_root, "tiny-closed", 2 ** 31 + 41, 0.3, False,
                      time.monotonic(), device="cpu", log=lambda *a, **k: 0)
    assert picked and res["correct"] is False
    assert res["checks"]["step0_rel_l2"]["value"] <= \
        res["checks"]["step0_rel_l2"]["limit"]
    assert res["checks"]["stepk_rel_l2"]["value"] > \
        res["checks"]["stepk_rel_l2"]["limit"]
