"""The port's ServingEngine against the JAX package's, end to end.

The same requests go through ``repro.serving.engine.ServingEngine`` and
``repro_torch.serving.engine.ServingEngine(device="cpu")``.  The JAX
pipeline's weights are livened (``repro.serving.cache_demo._liven``) and
converted into the port; the port's two per-request draws (prompt tokens
and initial noise) are replaced by JAX's own.  Each case must give an
identical control-plane ``trace_signature`` and decoded pixels within
1e-4 relative L2 (DESIGN.md §12's pixel budget).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import trajectory as jtraj  # noqa: E402
from repro.serving.cache_demo import _liven  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.core import policies as tpolicies  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import trajectory as ttraj  # noqa: E402
from repro_torch.diffusion.pipeline import (TorchDiTPipeline,  # noqa: E402
                                            _req_seed)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402

PIXEL_BUDGET = 1e-4


JAX = types.SimpleNamespace(sched=jsched, traj=jtraj, policies=jpolicies)
PORT = types.SimpleNamespace(sched=tsched, traj=ttraj, policies=tpolicies)


def fixed_sp(pkg, k, cfg=1):
    """The fixed-SP policy of tests/test_serving_engine.py on one
    package's control-plane types; denoise layouts split into ``cfg``
    guidance branches."""
    class FixedSP(pkg.sched.Policy):
        name = "fixed-sp"

        def schedule(self, view):
            out, free = [], list(view.free_ranks)
            for t, req, g in sorted(view.ready, key=lambda x: x[0].id):
                denoise = t.kind == "denoise"
                n = k if denoise else 1
                if len(free) < n:
                    break
                out.append(pkg.sched.Decision(t.id, pkg.traj.ExecutionLayout(
                    tuple(free[:n]), cfg=cfg if denoise else 1)))
                free = free[n:]
            return out
    return FixedSP()


class JaxDraws(TorchDiTPipeline):
    """The port's pipeline drawing JAX's prompt tokens and noise
    (repro/diffusion/pipeline.py:155-180)."""

    def _prompt_tokens(self, req):
        key = jax.random.PRNGKey(_req_seed(req.id))
        toks = jax.random.randint(key, (1, 77), 0, self.txt_cfg.vocab_size)
        return torch.from_numpy(np.array(toks)).long()

    def _initial_noise(self, req, shape):
        key = jax.random.PRNGKey(_req_seed(req.id))
        return np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                            shape, jnp.float32))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _request(pkg, rid="r0", **kw):
    return pkg.traj.Request(id=rid, model="dit-image", height=64, width=64,
                            frames=1, steps=3, arrival=0.0, **kw)


def _serve_both(monkeypatch, policy, requests, cache_interval=None):
    """Serve ``requests(pkg)`` under ``policy(pkg)`` on both engines and
    hold the port to JAX; returns the port's denoise cache modes and the
    batch size of each packed dispatch."""
    jeng = JaxEngine(JAX_DIT_IMAGE.reduced(), policy(JAX), 4, seed=0,
                     cache_interval=cache_interval)
    monkeypatch.setattr(torch_engine, "TorchDiTPipeline", JaxDraws)
    teng = torch_engine.ServingEngine(
        DIT_IMAGE.reduced(), policy(PORT), 4, seed=0,
        cache_interval=cache_interval, device="cpu")
    try:
        _liven(jeng.pipeline)
        jp, tp = jeng.pipeline, teng.pipeline
        load_jax_params(tp.dit, _numpy_tree(jp.dit_params))
        load_jax_params(tp.text_encoder, _numpy_tree(jp.txt_params))
        load_jax_params(tp.vae, _numpy_tree(jp.vae_params))
        jreqs, treqs = requests(JAX), requests(PORT)
        jeng.serve(jreqs, timeout=240)
        ops.reset_launches()
        teng.serve(treqs, timeout=240)
        signatures = (jsched.trace_signature(jeng.cp.events),
                      tsched.trace_signature(teng.cp.events))
        pixels = [(jeng.result_pixels(j), teng.result_pixels(t))
                  for j, t in zip(jreqs, treqs)]
        modes = [e.get("cache") for e in teng.cp.events
                 if e["ev"] == "dispatch" and e["kind"] == "denoise"]
        packs = [e["batch"] for e in teng.cp.events
                 if e["ev"] == "packed_dispatch"]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert signatures[0] == signatures[1]
    for want, got in pixels:
        assert want is not None and got is not None
        assert np.abs(want).max() > 0
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= PIXEL_BUDGET, err
    # the CPU run took the plain versions: no kernel was launched
    assert not any(ops.launches.values())
    return modes, packs


def test_engine_sp1_matches_jax(monkeypatch):
    modes, _ = _serve_both(monkeypatch, lambda pkg: fixed_sp(pkg, 1),
                           lambda pkg: [_request(pkg)])
    assert modes == [None, None, None]


def test_engine_sp2_cache_refresh_and_hit_match_jax(monkeypatch):
    modes, _ = _serve_both(monkeypatch, lambda pkg: fixed_sp(pkg, 2),
                           lambda pkg: [_request(pkg)], cache_interval=2)
    assert modes == ["refresh", "hit", "refresh"]


@pytest.mark.parametrize("k,cfg", [(2, 1), (4, 2)])
def test_engine_guided_matches_jax(monkeypatch, k, cfg):
    """Batched guidance on one group (cfg=1) and the cfg2 x sp2 split
    with its merge exchange (DESIGN.md §14)."""
    _serve_both(monkeypatch, lambda pkg: fixed_sp(pkg, k, cfg),
                lambda pkg: [_request(pkg, guidance=4.0)])


def test_engine_step_packing_matches_jax(monkeypatch):
    """Three requests denoised as packed SP-2 batches (DESIGN.md §9)."""
    _, packs = _serve_both(
        monkeypatch,
        lambda pkg: pkg.policies.PackingPolicy(degree=2, max_pack=4),
        lambda pkg: [_request(pkg, f"pk{i}") for i in range(3)])
    assert packs == [3, 3, 3]
