"""The port's training path against the JAX package's, on the CPU.

* ``adamw_update`` against JAX's on the same numpy gradients (three
  steps, with and without the clip) <= 1e-6; compression and its byte
  count equal to JAX's; ``TokenPipeline`` batches equal to JAX's (after
  ``start_step`` and ``seek`` too); ``StragglerMonitor`` as JAX's;
  ``ResilientTrainer``'s crash/restart reproducing the uninterrupted run
  exactly; ``synth_batch`` of JAX's shapes and dtypes.
* One step of reduced yi-6b (dense), mixtral-8x7b (MoE), whisper-medium
  (encdec), mamba2-1.3b (ssm), zamba2-7b (hybrid) and DIT_IMAGE: each package's ``forward(..., dtype=float32)``
  composed with ``cross_entropy`` (or the flow-matching loss), the loss
  and its gradient per parameter leaf against ``jax.value_and_grad`` on
  the same weights (``convert.load_jax_params``) and the same numpy
  batch: rel-L2 <= 1e-5 per leaf, loss and the global gradient norm
  <= 1e-5.  The DiT's adaLN weights are livened (at the JAX init they
  are zero and every attention and adaLN call would get a zero upstream
  gradient).  The whole ``train_step`` against JAX's ``make_train_step``
  in bf16 (loss, ``grad_norm``, each leaf's update where JAX's
  gradient is well above rounding): <= 3e-2.
* Five bf16 steps of the reduced DiT: loss and grad norm per step
  against JAX's (3e-2), through ``dit_lr_witness.trajectories``.
* ``dit.forward`` against JAX's ``dit.forward`` in fp32 (1e-5) and bf16
  (3e-2), ``remat`` none and full; remat's gradients equal none's.
* The ``ssm`` and ``hybrid`` families (reduced mamba2-1.3b and
  zamba2-7b) in the same fp32 loss-and-gradient comparison, at the JAX
  init and with A and dt in Mamba2's published ranges over three chunks;
  in the bf16 step and the remat comparison.  The port's CPU SSD is the
  sequential ``ssd_ref`` with the chunked closed-form ``ssd_bwd_ref`` as
  its backward, JAX's the chunked ``ssd_chunked``: two summation orders,
  within 1e-5 all the same (worst leaf 3.9e-6, zamba2 at the JAX init).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import dit as jdit  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.serving.cache_demo import _liven as jax_liven  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import fault_tolerance as jft  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import STACKED, _flatten, load_jax_params  # noqa: E402
from repro_torch.models import dit, get_model  # noqa: E402
from repro_torch.training import compression, data, fault_tolerance  # noqa: E402
from repro_torch.training import optimizer, train_lm, train_loop  # noqa: E402
import dit_lr_witness  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5
BF16_TOL = 3e-2


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _by_name(tree) -> dict:
    """A JAX tree's leaves by the port's parameter names (stacked layer
    axes split, as ``convert.load_jax_params`` does)."""
    out = {}
    for name, arr in _flatten(tree):
        top, _, rest = name.partition(".")
        axes = STACKED.get(top, 0)
        if axes:
            for idx in np.ndindex(arr.shape[:axes]):
                out[".".join([top, *map(str, idx), rest])] = arr[idx]
        else:
            out[name] = arr
    return out


# ---------------------------------------------------------------------------
# optimizer, compression, data, fault tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gscale", [0.01, 10.0])   # below / above the clip
def test_adamw_update_matches_jax(gscale):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = optimizer.adamw_init(tp)
    for step in range(3):
        grads = {k: (gscale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, grads),
                                       js, jp, lr=1e-2)
        ts, tm = optimizer.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp,
            lr=1e-2)
        assert int(ts.step) == int(js.step) == step + 1
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        for k in shapes:
            assert _rel(tp[k], jp[k]) <= 1e-6, k
            assert _rel(ts.m[k], js.m[k]) <= 1e-6, k
            assert _rel(ts.v[k], js.v[k]) <= 1e-6, k


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compression_matches_jax(method):
    rng = np.random.default_rng(1)
    grads = {"w": rng.standard_normal((40, 30)).astype(np.float32),
             "small": rng.standard_normal((4, 4)).astype(np.float32),
             "s": np.float32(3.0)}
    got = compression.compress_decompress(
        {k: torch.as_tensor(v) for k, v in grads.items()}, method)
    want = jcomp.compress_decompress(jax.tree.map(jnp.asarray, grads),
                                     method)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert compression.compressed_bytes(got, method) == \
        jcomp.compressed_bytes(want, method)
    if method == "topk":    # 10% of the entries survive
        assert int((got["w"] != 0).sum()) == 120


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium",
                                  "paligemma-3b"])
def test_token_pipeline_matches_jax(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    pipes = [data.TokenPipeline(cfg, 2, 12, seed=5, start_step=3),
             jdata.TokenPipeline(jcfg, 2, 12, seed=5, start_step=3)]
    try:
        for _ in range(3):
            a, b = (next(p) for p in pipes)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        for p in pipes:
            p.seek(1)
        a, b = (next(p) for p in pipes)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert pipes[0].cursor() == pipes[1].cursor() == 2
    finally:
        for p in pipes:
            p.close()


def test_straggler_monitor_matches_jax():
    mons = [fault_tolerance.StragglerMonitor(world=4),
            jft.StragglerMonitor(world=4)]
    for m in mons:
        assert m.deadline() == float("inf")
        for s in (1.0, 3.0, 2.0, 10.0):
            m.observe(s)
    assert mons[0].deadline() == mons[1].deadline() == 9.0
    rng = np.random.default_rng(2)
    per = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
            "b": [rng.standard_normal(2).astype(np.float32)]}
           for _ in range(4)]
    per[2] = None
    got = mons[0].aggregate(
        [None if g is None else {"w": torch.from_numpy(g["w"]),
                                 "b": [torch.from_numpy(g["b"][0])]}
         for g in per])
    want = mons[1].aggregate(per)
    np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), want["b"][0], rtol=1e-6)
    assert mons[0].skipped == mons[1].skipped == 1
    with pytest.raises(RuntimeError, match="all workers straggled"):
        mons[0].aggregate([None, None])


def _tiny_lm():
    kw = dict(num_layers=1, d_model=64, d_ff=128, vocab_size=128,
              num_heads=2, num_kv_heads=2, head_dim=32)
    return get_config("yi-6b").reduced(**kw)


def test_crash_restart_resumes_exact_stream(tmp_path):
    """JAX's ``test_crash_restart_resumes_exact_stream`` on the port: a
    crash at step 5 and a restart from the step-4 checkpoint and the data
    cursor reproduce the uninterrupted run's weights and moments
    exactly."""
    cfg = _tiny_lm()
    step_fn = train_loop.make_train_step(cfg, remat="none", lr=1e-3)

    def init_state():
        m = get_model(cfg).init(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        return m, optimizer.adamw_init(dict(m.named_parameters()))

    def mkpipe():
        return data.TokenPipeline(cfg, batch=2, seq=16, seed=9)

    class Batches:                    # numpy batches -> tensors
        def __init__(self):
            self.p = mkpipe()

        def __next__(self):
            return {k: torch.from_numpy(v) for k, v in next(self.p).items()}

        def seek(self, s):
            self.p.seek(s)

        def cursor(self):
            return self.p.cursor()

    ref = fault_tolerance.ResilientTrainer(tmp_path / "ref", step_fn,
                                           init_state, save_every=100,
                                           async_save=False)
    out_ref = ref.run(Batches(), num_steps=8)
    tr = fault_tolerance.ResilientTrainer(tmp_path / "crash", step_fn,
                                          init_state, save_every=2,
                                          async_save=False)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tr.run(Batches(), num_steps=8, crash_at=5)
    out2 = fault_tolerance.ResilientTrainer(
        tmp_path / "crash", step_fn, init_state, save_every=2,
        async_save=False).run(Batches(), num_steps=8)
    (m1, o1), (m2, o2) = out_ref["state"], out2["state"]
    assert int(o1.step) == int(o2.step) == 8
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
        assert torch.equal(o1.m[name], o2.m[name]), name
        assert torch.equal(o1.v[name], o2.v[name]), name
    assert float(out_ref["metrics"]["loss"]) == \
        float(out2["metrics"]["loss"])


@pytest.mark.parametrize("arch", ["dit-image", "yi-6b", "whisper-medium",
                                  "paligemma-3b"])
def test_synth_batch_has_jax_shapes_and_dtypes(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    got = train_loop.synth_batch(cfg, 2, 12, device="cpu")
    want = jtl.synth_batch(jcfg, 2, 12, as_specs=True)
    specs = train_loop.synth_batch(cfg, 2, 12, as_specs=True)
    assert got.keys() == want.keys() == specs.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(specs[k].shape) == \
            want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if arch == "dit-image":
        assert 0 <= float(got["t"].min()) and float(got["t"].max()) < 1000


# ---------------------------------------------------------------------------
# one step against JAX's
# ---------------------------------------------------------------------------

LM_CASES = {
    "yi-6b": ("yi-6b", {}),
    "mixtral-8x7b": ("mixtral-8x7b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "zamba2-7b": ("zamba2-7b", {}),
}


def _lm_pair(case):
    arch, overrides = LM_CASES[case]
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    params, _ = jL.split_params(
        jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    return jcfg, cfg, params, model


def _lm_batch(cfg, seed=3, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return out


def _dit_pair():
    jcfg = jax_get_config("dit-image").reduced()
    cfg = get_config("dit-image").reduced()
    params, _ = jL.split_params(jdit.init(jax.random.PRNGKey(0), jcfg))
    holder = types.SimpleNamespace(dit_params=params)
    jax_liven(holder)
    model = dit.init(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, holder.dit_params))
    return jcfg, cfg, holder.dit_params, model


def _dit_batch(cfg, t, seed=4, hw=16):
    rng = np.random.default_rng(seed)
    b = len(t)
    shape = (b, 1, hw, hw, cfg.dit.in_channels)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32),
            "t": np.asarray(t, np.float32),
            "txt": rng.standard_normal((b, 8, cfg.dit.cond_dim))
            .astype(np.float32)}


def _port_loss(cfg, model, batch, dtype=torch.float32):
    """The port's training loss, composed with ``dtype``'s forward."""
    fam = get_model(cfg)
    if cfg.family == "dit":
        lat, noise, t = batch["latents"], batch["noise"], batch["t"]
        sigma = (t / 1000.0)[:, None, None, None, None]
        v = fam.forward(model, (1 - sigma) * lat + sigma * noise, t,
                        batch["txt"], cfg, dtype=dtype)
        return torch.mean((v - (noise - lat)) ** 2)
    if cfg.family == "encdec":
        logits, aux = fam.forward(model, batch["tokens"], batch["frames"],
                                  cfg, dtype=dtype)
    else:
        logits, aux = fam.forward(model, batch["tokens"], cfg, dtype=dtype)
    return train_loop.cross_entropy(logits, batch["labels"]) + 0.01 * aux


def _jax_loss(jcfg, params, batch, dtype=jnp.float32):
    fam = jax_get_model(jcfg)
    if jcfg.family == "dit":
        lat, noise, t = batch["latents"], batch["noise"], batch["t"]
        sigma = (t / 1000.0)[:, None, None, None, None]
        v = fam.forward(params, (1 - sigma) * lat + sigma * noise, t,
                        batch["txt"], jcfg, dtype=dtype)
        return jnp.mean((v - (noise - lat)) ** 2)
    if jcfg.family == "encdec":
        logits, aux = fam.forward(params, batch["tokens"], batch["frames"],
                                  jcfg, dtype=dtype)
    else:
        logits, aux = fam.forward(params, batch["tokens"], jcfg, dtype=dtype)
    return jtl.cross_entropy(logits, batch["labels"]) + 0.01 * aux


def _port_grads(cfg, model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        loss = _port_loss(cfg, model, tb)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return float(loss.detach()), {n: np.zeros(p.shape, np.float32) if g is None
                         else g.numpy() for (n, p), g in zip(params.items(),
                                                             got)}


def _compare_grads(loss, grads, jloss, jgrads, tol=TOL):
    jg = _by_name(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == jg.keys()
    assert abs(loss - float(jloss)) <= tol * abs(float(jloss))
    worst = {n: _rel(grads[n], jg[n]) for n in grads
             if np.linalg.norm(jg[n]) > 0}
    bad = {n: e for n, e in worst.items() if e > tol}
    assert not bad, bad
    gn = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                     for g in grads.values()))
    jgn = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                      for g in jg.values()))
    assert abs(gn - jgn) <= tol * jgn
    # every leaf with a JAX gradient has a port gradient, and vice versa
    assert {n for n in grads if np.any(grads[n])} == \
        {n for n in jg if np.any(jg[n])}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_loss_and_gradients_match_jax(case):
    jcfg, cfg, params, model = _lm_pair(case)
    batch = _lm_batch(cfg)
    loss, grads = _port_grads(cfg, model, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg, p, batch)))(params)
    _compare_grads(loss, grads, jloss, jgrads)


def _liven_ssd(tree, seed=0):
    """Every ``A_log`` and ``dt_bias`` leaf of a JAX tree redrawn in
    Mamba2's published ranges (dt log-uniform in [1e-3, 1e-1] through the
    inverse softplus, A = -U[1, 16]), so that the state carried across
    chunks, and its gradient, are not ~0 as at the JAX init."""
    rng = np.random.default_rng(seed)
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _liven_ssd(leaf, int(rng.integers(2**31)))
        elif key == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), leaf.shape))
            tree[key] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        elif key == "A_log":
            tree[key] = np.log(rng.uniform(1, 16, leaf.shape)).astype(
                np.float32)
    return tree


@pytest.mark.parametrize("arch,overrides", [
    ("mamba2-1.3b", {}), ("zamba2-7b", {"num_layers": 5})],
    ids=["mamba2-1.3b", "zamba2-7b"])
def test_ssd_families_with_published_a_dt_match_jax(arch, overrides):
    """The ``ssm`` and ``hybrid`` families' loss and per-leaf gradients
    against ``jax.value_and_grad`` with A and dt in Mamba2's published
    ranges and 40 tokens, three chunks of 16 (the last ragged), so the
    state pass and its gradient (K4's backward's reverse pass) carry; the
    hybrid at five layers has two groups and a Mamba2 tail.  The port's
    CPU forward is the sequential ``ssd_ref`` and its backward the
    chunked ``ssd_bwd_ref``, JAX's both the chunked ``ssd_chunked``: two
    summation orders, yet within the fp32 1e-5 (measured: worst leaf
    rel-L2 2.96e-6, mamba2's ``A_log``; 3.30e-6, a zamba2 ``dt_bias``)."""
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    params, _ = jL.split_params(
        jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tree = _liven_ssd(jax.tree.map(np.asarray, params))
    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    batch = _lm_batch(cfg, s=40)
    loss, grads = _port_grads(cfg, model, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg, p, batch)))(jax.tree.map(jnp.asarray,
                                                           tree))
    _compare_grads(loss, grads, jloss, jgrads)


@pytest.mark.parametrize("t", [[3.5, 90.0], [640.0, 999.0]],
                         ids=["small-t", "large-t"])
def test_dit_loss_and_gradients_match_jax(t):
    """The flow-matching loss through the DiT (livened adaLN), fp32.  At
    large t the timestep embedding's phase (t x freq, ~1000 rad) carries
    the frameworks' one-ulp ``exp`` difference as ~6e-5 into the
    conditioning (``tests/test_torch_models.py``); every leaf's gradient
    still holds 1e-5 here."""
    jcfg, cfg, params, model = _dit_pair()
    batch = _dit_batch(cfg, t)
    loss, grads = _port_grads(cfg, model, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg, p, batch)))(params)
    _compare_grads(loss, grads, jloss, jgrads)


@pytest.mark.parametrize("case", ["yi-6b", "mixtral-8x7b", "dit-image",
                                  "mamba2-1.3b", "zamba2-7b"])
def test_train_step_matches_jax_in_bf16(case):
    """The whole step (bf16 forward, as JAX's ``loss_fn`` runs it; AdamW)
    against JAX's ``make_train_step``: loss, ``grad_norm`` and each leaf's
    update (new - old weights) within the bf16 budget.  AdamW's first
    step moves a weight by about lr * sign(g), so the update is held where
    JAX's gradient is above a third of its leaf's RMS: where it is near
    zero, bf16 rounding may flip its sign on either side."""
    if case == "dit-image":
        jcfg, cfg, params, model = _dit_pair()
        batch = _dit_batch(cfg, [250.0, 700.0])
    else:
        jcfg, cfg, params, model = _lm_pair(case)
        batch = _lm_batch(cfg)
    jgrads = _by_name(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jtl.loss_fn(p, batch, jcfg, "none")[0]))(params)))
    jstep = jax.jit(jtl.make_train_step(jcfg, remat="none", lr=3e-4))
    jnew, _, jm = jstep(params, jopt.adamw_init(params), batch)
    old = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    step = train_loop.make_train_step(cfg, remat="none", lr=3e-4)
    opt = optimizer.adamw_init(dict(model.named_parameters()))
    model, opt, m = step(model, opt, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in batch.items()})
    assert int(opt.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        BF16_TOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        BF16_TOL * float(jm["grad_norm"])
    want = _by_name(jax.tree.map(np.asarray, jnew))
    for name, p in model.named_parameters():
        assert not p.requires_grad            # left as it was found
        g = np.abs(jgrads[name])
        held = g > np.sqrt(np.mean(np.square(g, dtype=np.float64))) / 3
        assert held.any(), name
        assert _rel((p.detach().numpy() - old[name])[held],
                    (want[name] - old[name])[held]) <= BF16_TOL, name


def test_dit_trajectory_matches_jax():
    """Five bf16 AdamW steps at lr 3e-4 of the reduced, livened DiT on one
    batch (``dit_lr_witness.trajectories``, which makes the same
    comparison at DIT_IMAGE's full width): each step's loss and grad norm
    within the bf16 budget of JAX's ``make_train_step``'s."""
    want, got = dit_lr_witness.trajectories(
        jax_get_config("dit-image").reduced(),
        get_config("dit-image").reduced(), steps=5, lr=3e-4, hw=16)
    assert len(got) == len(want) == 5
    for (jl, jg), (pl, pg) in zip(want, got):
        assert abs(pl - jl) <= BF16_TOL * abs(jl), (want, got)
        assert abs(pg - jg) <= BF16_TOL * jg, (want, got)
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_dit_forward_matches_jax(dtype, tol, remat):
    jcfg, cfg, params, model = _dit_pair()
    batch = _dit_batch(cfg, [30.0, 500.0], hw=8)
    for p in model.parameters():      # remat acts where grads are taken
        p.requires_grad_(True)
    got = dit.forward(model, torch.from_numpy(batch["latents"]),
                      torch.from_numpy(batch["t"]),
                      torch.from_numpy(batch["txt"]), cfg,
                      dtype=getattr(torch, dtype), remat=remat)
    want = jdit.forward(params, batch["latents"], batch["t"], batch["txt"],
                        jcfg, dtype=getattr(jnp, dtype), remat=remat)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.detach().numpy(), want) <= tol


@pytest.mark.parametrize("arch,remats", [
    ("dit-image", ("full",)), ("yi-6b", ("full", "selective")),
    ("mamba2-1.3b", ("full",)), ("zamba2-7b", ("full",))])
def test_remat_gives_the_same_gradients(arch, remats):
    cfg = get_config(arch).reduced()
    model = get_model(cfg).init(cfg, device="cpu")
    if cfg.family == "dit":
        dit.liven_adaln(model, cfg.d_model)
        batch = {k: torch.from_numpy(v)
                 for k, v in _dit_batch(cfg, [100.0, 800.0], hw=8).items()}
    else:
        batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg).items()}
    loss, _, grads = train_loop.grads_of(model, batch, cfg, "none")
    for remat in remats:
        loss_r, _, grads_r = train_loop.grads_of(model, batch, cfg, remat)
        assert float(loss_r) == float(loss)
        for name in grads:
            assert torch.allclose(grads_r[name], grads[name], rtol=1e-5,
                                  atol=1e-7), (remat, name)


def _small_lm(arch):
    """A smaller LM than the trainer's own, so that the 200 steps random
    tokens need before the loss falls take seconds here."""
    return get_config(arch).reduced(num_layers=2, d_model=64, num_heads=4,
                                    num_kv_heads=2, head_dim=16, d_ff=128,
                                    vocab_size=512)


@pytest.mark.parametrize("arch,extra", [
    ("yi-6b", ["--steps", "200"]),
    ("mamba2-1.3b", ["--steps", "200"]),
    ("dit-image", ["--steps", "5"])])
def test_train_lm_runs_on_the_cpu(tmp_path, monkeypatch, capsys, arch,
                                  extra):
    """The port's command-line trainer on the CPU, its own check included
    (exit 0 only if the last loss is below the first, as the JAX
    example asserts): 200 steps of a small LM (dense, or Mamba2 through
    the SSD's backward), or 5 of the reduced DiT, whose loss on its one
    batch falls at every step; checkpoints kept."""
    if arch != "dit-image":
        monkeypatch.setattr(train_lm, "reduced_config", _small_lm)
    assert train_lm.main(["--device", "cpu", "--arch", arch, "--ckpt",
                          str(tmp_path), *extra]) == 0
    out = capsys.readouterr().out
    steps = int(extra[1])
    assert f"steps [{steps}]" in out or f"steps [150, {steps}]" in out
    assert (tmp_path / f"step_{steps}" / "meta.json").exists()
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == min(steps, 10) and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    if arch == "dit-image":
        assert all(b < a for a, b in zip(losses, losses[1:])), losses
