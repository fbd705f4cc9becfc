"""K2's and K3's bf16 tensor-core forward in closed form, on the CPU.

The card's kernel (``csrc/attention.cu``, ``attn_mma_kernel``) cannot run
here, so its arithmetic is written out in PyTorch, rounding where it
rounds: bf16 Q, K and V; S = Q K^T as exact products of the bf16 operands
summed in fp32; per key tile (64 keys, 32 at d = 256, walked segment by
segment as the kernel walks them) the online softmax in fp32, its row sum
adding the fp32 P, then P rounded to bf16 before O += P V in fp32; the
output rounded to bf16.  With split keys, each piece of whole tiles keeps
its unnormalized O, its row max and its row sum, and the pieces are
merged by log-sum-exp in fp32, as ``attn_combine_kernel`` merges them.

Held, per case, within the bf16 budget of 3e-2 (DESIGN.md §12) against
the JAX package's ``flash_attention`` / ``splice_attention`` Pallas
kernels in interpret mode (which keep P in fp32) and against the port's
plain version ``ref.attention_ref`` on the same bf16 inputs; and, in
fp32 (no rounding), the merge of split pieces against the unsplit walk
within 1e-6 and its log-sum-exp against ``ref.attention_lse_ref`` within
1e-6.  Each test prints the distances it measured.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

BF16_BUDGET = 3e-2
MERGE_BUDGET = 1e-6
NEG_INF = -1e30
LOG2E = 1.4426950408889634

#: (b, sq, sk, h, kv, d, causal): decode steps (Sq = 1) and a prompt's
#: few queries (Sq = 4) over ragged keys, the text encoder's 77, GQA,
#: causal (Sq = Sk), at head dims 16, 64 and 112 (7 k steps, 14 n tiles)
CASES = [
    (2, 1, 300, 4, 4, 64, False),
    (1, 4, 300, 8, 2, 64, False),
    (1, 77, 77, 4, 4, 16, False),
    (1, 77, 77, 4, 2, 112, True),
    (2, 4, 200, 4, 1, 112, False),
    (1, 1, 130, 2, 2, 16, False),
    (1, 130, 130, 2, 2, 64, True),
]
#: (sq, sk, offset, n, d): the splice's fresh rows [offset, offset + n)
#: with both edges inside a 64-key tile, at the three head dims
SPLICE_CASES = [
    (4, 300, 77, 100, 64),
    (77, 300, 130, 77, 16),
    (1, 300, 0, 37, 112),
    (4, 200, 150, 50, 112),
]


def _bk(d: int) -> int:
    return 64 if d <= 128 else 32


def _tiles(segments, lo, hi, bk):
    """The kernel's key tiles [k0, k1) within the window [lo, hi): each
    segment [begin, end) from max(begin, lo) in steps of bk."""
    for begin, end in segments:
        k0, stop = max(begin, lo), min(end, hi)
        while k0 < stop:
            yield k0, min(k0 + bk, stop)
            k0 += bk


def _windows(sk, bk, splits):
    """The pieces of whole tiles the keys split into, as the library's
    plan spreads ``splits`` pieces (None: one window, no split)."""
    if splits is None:
        return [(0, sk)]
    ktiles = -(-sk // bk)
    per = -(-ktiles // splits)
    keys = per * bk
    return [(z * keys, (z + 1) * keys) for z in range(-(-ktiles // per))]


def mma_forward(q, k, v, *, causal=False, segments=None, splits=None,
                rounded=True):
    """The tensor-core forward in closed form: (out, lse).  q (B, Sq, H,
    d); k, v (B, Sk, KV, d), already spliced; ``segments`` the key walk
    ((begin, end) pairs; one segment by default); ``splits`` the pieces
    of split keys (None: none); ``rounded`` False keeps P and the output
    in fp32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    bk = _bk(d)
    sl2 = d ** -0.5 * LOG2E
    kr = torch.repeat_interleave(k.float(), h // kv, dim=2)
    vr = torch.repeat_interleave(v.float(), h // kv, dim=2)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    qi = torch.arange(sq)[:, None]
    pieces = []
    for lo, hi in _windows(sk, bk, splits):
        m = torch.full((b, h, sq), NEG_INF)
        l = torch.zeros((b, h, sq))
        o = torch.zeros((b, h, sq, d))
        for k0, k1 in _tiles(segments or [(0, sk)], lo, hi, bk):
            s = s_all[..., k0:k1]
            if causal:
                s = torch.where(torch.arange(k0, k1)[None, :] > qi, NEG_INF,
                                s)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mx) * sl2)
            mc = torch.where(mx == NEG_INF, 0.0, mx * sl2)
            p = torch.exp2(s * sl2 - mc[..., None])
            l = l * alpha + p.sum(-1)
            if rounded:
                p = p.to(torch.bfloat16).float()
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vr[:, k0:k1])
            m = mx
        pieces.append((o, m * sl2, l))
    if len(pieces) == 1:
        o, m2, l = pieces[0]
        out = o / l.clamp_min(1e-30)[..., None]
        lse = (m2 + torch.log2(l)) * math.log(2)
    else:
        big = torch.stack([m2 for _, m2, _ in pieces]).amax(0)
        w = [torch.exp2(m2 - big) for _, m2, _ in pieces]
        total = sum(l * wz for (_, _, l), wz in zip(pieces, w))
        out = sum(o * wz[..., None] for (o, _, _), wz in zip(pieces, w))
        out = out / total.clamp_min(1e-30)[..., None]
        lse = (big + torch.log2(total)) * math.log(2)
    out = out.transpose(1, 2)
    return (out.to(torch.bfloat16) if rounded else out), lse


def _bf16_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _dist(got, want):
    """(rel-L2, max abs over max |want|) in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (float(np.linalg.norm(got - want)
                  / max(np.linalg.norm(want), 1e-30)),
            float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("splits", [None, 3], ids=["tiles", "split3"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_attention_bf16_rounding_within_budget(case, splits):
    """The bf16 forward's rounding points (P to bf16 per key tile, the
    output to bf16), unsplit and over three split pieces, stay within
    the bf16 budget of JAX's interpret-mode ``flash_attention`` and of
    ``ref.attention_ref`` on the same bf16 inputs."""
    b, sq, sk, h, kv, d, causal = case
    q, k, v = _bf16_inputs([(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)],
                           seed=sq + sk + d)
    got, _ = mma_forward(q, k, v, causal=causal, splits=splits)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want_jax = jops.attention(*(jnp.asarray(_np(t)) for t in (q, k, v)),
                              causal=causal, use_pallas=True)
    want_ref = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
    to_jax, to_ref = _dist(_np(got), want_jax), _dist(_np(got), _np(want_ref))
    print(f"{case} splits={splits}: vs JAX flash_attention rel-L2 "
          f"{to_jax[0]:.3e} max {to_jax[1]:.3e}; vs ref.attention_ref "
          f"rel-L2 {to_ref[0]:.3e} max {to_ref[1]:.3e}")
    assert max(to_jax + to_ref) <= BF16_BUDGET


@pytest.mark.parametrize("splits", [None, 3], ids=["tiles", "split3"])
@pytest.mark.parametrize("case", SPLICE_CASES, ids=str)
def test_splice_bf16_rounding_within_budget(case, splits):
    """K3 through the same forward, walked over the splice's three
    segments (tiles restart at each segment's first key), within the
    bf16 budget of JAX's interpret-mode ``splice_attention`` and of
    ``ref.splice_attention_ref``."""
    sq, sk, offset, n, d = case
    h, kv = 4, 2
    q, ks, vs, kf, vf = _bf16_inputs(
        [(1, sq, h, d), (1, sk, kv, d), (1, sk, kv, d), (1, n, kv, d),
         (1, n, kv, d)], seed=offset + d)
    k, v = ks.clone(), vs.clone()
    k[:, offset:offset + n], v[:, offset:offset + n] = kf, vf
    segments = [(0, offset), (offset, offset + n), (offset + n, sk)]
    got, _ = mma_forward(q, k, v, segments=segments, splits=splits)
    want_jax = jops.splice_attention(
        *(jnp.asarray(_np(t)) for t in (q, ks, vs, kf, vf)), offset=offset,
        use_pallas=True)
    want_ref = ref.splice_attention_ref(*(t.float() for t in (q, ks, vs, kf,
                                                              vf)),
                                        offset=offset)
    to_jax, to_ref = _dist(_np(got), want_jax), _dist(_np(got), _np(want_ref))
    print(f"splice {case} splits={splits}: vs JAX splice_attention rel-L2 "
          f"{to_jax[0]:.3e} max {to_jax[1]:.3e}; vs ref rel-L2 "
          f"{to_ref[0]:.3e} max {to_ref[1]:.3e}")
    assert max(to_jax + to_ref) <= BF16_BUDGET


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_merge_equals_unsplit_in_fp32(case, splits):
    """Without rounding, the log-sum-exp merge of split pieces equals the
    unsplit walk within 1e-6, and its log-sum-exp equals
    ``ref.attention_lse_ref`` within 1e-6 (rel-L2)."""
    b, sq, sk, h, kv, d, causal = case
    rng = np.random.default_rng(sk + splits)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    whole, lse_whole = mma_forward(q, k, v, causal=causal, rounded=False)
    merged, lse = mma_forward(q, k, v, causal=causal, splits=splits,
                              rounded=False)
    to_whole = _dist(_np(merged), _np(whole))[0]
    want_lse = ref.attention_lse_ref(q, k, causal=causal)
    to_lse = _dist(_np(lse), _np(want_lse))[0]
    to_ref = _dist(_np(whole), _np(ref.attention_ref(q, k, v,
                                                     causal=causal)))[0]
    print(f"{case} splits={splits} fp32: merged vs unsplit rel-L2 "
          f"{to_whole:.3e}, lse vs ref {to_lse:.3e}; unsplit vs ref "
          f"{to_ref:.3e}")
    assert to_whole <= MERGE_BUDGET and to_lse <= MERGE_BUDGET
    assert to_ref <= MERGE_BUDGET
