"""The stage-wise SSD of ``csrc/ssd.cu`` (``ref.ssd_chunked_ref``) on the CPU.

K4 computes the Mamba2 SSD chunk-parallel: chunk-local states, a pass of
states across chunks, C·Bᵀ once per (batch, chunk) and a chunk scan.
Its plain stage-wise twin is held here to the JAX package's chunked jnp
oracle ``repro.models.ssm.ssd_chunked`` and to its interpret-mode Pallas
kernel ``repro.kernels.ssd.ssd_scan`` where ``l`` is a multiple of the
chunk (both chunked, so within 1e-5 of the largest reference value in
fp32), and to the sequential recurrence ``ref.ssd_ref`` at ragged ``l``,
the last chunk zero-filled as the kernel's masked loads do (two
summation orders: K4's 1e-4 budget).  A and dt are drawn in Mamba2's
published ranges (``ssm.sample_dt_a``), so the carried state matters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401


def _inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt.numpy(), A.numpy(), B, C


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (2, 64, 4, 16, 16, 16),       # mamba2-1.3b.reduced()'s shape
    (1, 128, 2, 16, 16, 32),
    (2, 256, 3, 32, 16, 64),
    (1, 256, 2, 64, 32, 128),
])
def test_ssd_chunked_ref_matches_the_jax_oracle_and_kernel(b, l, h, p, n,
                                                           chunk):
    inputs = _inputs(l + p + n, b, l, h, p, n)
    y, st = ref.ssd_chunked_ref(*_torch(*inputs), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    jin = tuple(jnp.asarray(a) for a in inputs)
    yj, sj = jssm.ssd_chunked(*jin, chunk)
    _close(y, yj, 1e-5)
    _close(st, sj, 1e-5)
    yk, sk = ssd_scan(*jin, chunk=chunk)
    _close(y, yk, 1e-5)
    _close(st, sk, 1e-5)


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 10, 2, 16, 16, 32),       # l < chunk: one partial chunk
    (2, 16, 3, 16, 16, 16),       # l equal to one chunk
    (2, 40, 4, 16, 16, 16),       # the reduced model's ragged prefill
    (1, 200, 3, 32, 16, 64),
    (1, 130, 2, 64, 32, 128),     # one row past the first chunk
])
def test_ssd_chunked_ref_matches_the_recurrence_at_ragged_l(b, l, h, p, n,
                                                            chunk):
    inputs = _torch(*_inputs(l + 7 * h, b, l, h, p, n))
    y, st = ref.ssd_chunked_ref(*inputs, chunk=chunk)
    yr, sr = ref.ssd_ref(*inputs)
    _close(y, yr, 1e-4)
    _close(st, sr, 1e-4)


def test_ssd_chunked_ref_carries_the_state_across_chunks():
    """x is zero past the first chunk, so every later y is the carried
    state's term alone, and it is not negligible."""
    x, dt, A, B, C = _inputs(11, 1, 96, 2, 16, 16)
    x[:, 16:] = 0
    dt[:] = 1e-3
    inputs = _torch(x, dt, A, B, C)
    y, st = ref.ssd_chunked_ref(*inputs, chunk=16)
    yr, sr = ref.ssd_ref(*inputs)
    assert y[:, 16:].abs().max() > 0.1 * y[:, :16].abs().max()
    _close(y, yr, 1e-4)
    _close(st, sr, 1e-4)


def test_ssd_chunked_ref_keeps_x_dtype_and_fp32_state():
    x, dt, A, B, C = _torch(*_inputs(3, 1, 20, 2, 16, 16))
    y, st = ref.ssd_chunked_ref(x.bfloat16(), dt, A, B.bfloat16(),
                                C.bfloat16(), chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert y.shape == x.shape


def test_ssd_wrapper_on_the_cpu_keeps_the_recurrence():
    """``ops.ssd`` on CPU tensors is the sequential plain version, not
    the stage-wise one: the two agree only to the K4 budget."""
    inputs = _torch(*_inputs(5, 1, 40, 2, 16, 16))
    y, st = ops.ssd(*inputs, chunk=16)
    yr, sr = ref.ssd_ref(*inputs)
    assert torch.equal(y, yr) and torch.equal(st, sr)
