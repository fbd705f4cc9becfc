"""Operation and byte counts of the kernels in ``csrc/``.

One home for what each kernel's function must do: the operations, two
per multiply-add, and the bytes it must move, each input read once and
each output written once.  ``chip_smoke.py`` divides them by the card's
rates for each kernel's bound; the dry run
(:mod:`repro_torch.launch.dryrun`) adds them to its FLOP and byte counts
where a traced call takes the kernels' shape-only branch.  Every
function returns ``(flops, bytes)`` as integers; ``es`` is the bytes of
one element of the kernel's dtype (4 for fp32, 2 for bf16).

This module imports nothing, so that a script can load it by path from
another checkout.
"""
from __future__ import annotations


def gemm(m: int, n: int, k: int) -> tuple[int, int]:
    """The fp32 product y (m, n) = x (m, k) @ w (k, n): 2 k operations an
    output; x and w read, y written (fp32)."""
    return 2 * m * n * k, 4 * (m * k + k * n + m * n)


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs one head scores: the lower triangle when
    causal (Sq == Sk), else all of them."""
    return sq * (sq + 1) // 2 if causal else sq * sk


def attention(b: int, sq: int, sk: int, h: int, kv: int, d: int,
              causal: bool, es: int, lse: bool = False) -> tuple[int, int]:
    """K2's forward: q·kᵀ and p·v, 2 d operations each a pair; q read and
    the output written, k and v read, the fp32 log-sum-exp written when
    asked for."""
    flops = 4 * b * h * d * _pairs(sq, sk, causal)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kv * d) * es
    if lse:
        nbytes += 4 * b * h * sq
    return flops, nbytes


def attention_bwd(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                  causal: bool, es: int) -> tuple[int, int]:
    """K2's backward: five products of 2 d operations a pair (S, dP, dV,
    dK, dQ); q, o and dO read and dq written, k and v read and dk and dv
    written, the fp32 log-sum-exp read."""
    flops = 10 * d * b * h * _pairs(sq, sk, causal)
    nbytes = 4 * (b * sq * h * d + b * sk * kv * d) * es + 4 * b * h * sq
    return flops, nbytes


def splice_attention(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                     es: int) -> tuple[int, int]:
    """K3: K2's bidirectional work over the spliced ``sk`` keys; the
    stale K/V read whole (the fresh rows stand in for as many of them)."""
    return attention(b, sq, sk, h, kv, d, False, es)


def adaln(b: int, n: int, d: int, *, ln: bool, mod: bool, gated: bool,
          es: int) -> tuple[int, int]:
    """K1's forward over (b, n, d): 6 operations an element for the
    norm, 2 for the modulation, 2 for the gated residual; x read and the
    output written (and the residual read), the (b, d) rows read."""
    per_elem = 6 * ln + 2 * mod + 2 * gated
    rows = 2 + gated
    mod_rows = 2 * mod + gated
    return per_elem * b * n * d, (rows * b * n + mod_rows * b) * d * es


def adaln_bwd(b: int, n: int, d: int, *, ln: bool, mod: bool, gated: bool,
              es: int) -> tuple[int, int]:
    """K1's backward: 10 operations an element for the norm, 2 for the
    modulation, 4 for the gate; x and dy read and dx written, the (b, d)
    rows read and their gradients written (the residual's gradient is dy
    itself: nothing moves for it)."""
    per_elem = 10 * ln + 2 * mod + 4 * gated
    mod_rows = 2 * mod + gated
    return per_elem * b * n * d, (3 * b * n + 2 * mod_rows * b) * d * es


def ssd_flops(b: int, l: int, h: int, p: int, n: int, c: int) -> int:
    """Operations the SSD function needs, two per multiply-add: per
    (batch, chunk) of r rows the causal C·Bᵀ once (B and C have one
    group), r(r+1)/2 · n; per head the causal scores·xb, r(r+1)/2 · p,
    C·state, r·p·n (none in the first chunk, whose state is zero), and
    the state update, r·p·n."""
    total = 0
    for k, l0 in enumerate(range(0, l, c)):
        r = min(c, l - l0)
        tri = r * (r + 1) // 2
        total += tri * n + h * (tri * p + (2 if k else 1) * r * p * n)
    return 2 * b * total


def ssd(b: int, l: int, h: int, p: int, n: int, c: int,
        es: int) -> tuple[int, int]:
    """K4's forward: :func:`ssd_flops`; x and B, C read and y written in
    the operands' dtype, dt and A read and the final state written in
    fp32."""
    nbytes = (2 * b * l * h * p + 2 * b * l * n) * es \
        + (b * l * h + h + b * h * p * n) * 4
    return ssd_flops(b, l, h, p, n, c), nbytes


def ssd_bwd_flops(b: int, l: int, h: int, p: int, n: int, c: int,
                  dstate: bool = False) -> int:
    """Operations K4's backward needs, two per multiply-add: per (batch,
    chunk) of r rows, the causal triangles of the dB and dC products once,
    2 r(r+1)/2 n (B and C have one group, so each head's L (dy . xb) is
    summed over the heads first); per head the triangles of dy . xb and
    of the dxb product, 2 r(r+1)/2 p, and r p n for each of the chunk's
    state gradient Q and S_in^T dy (neither in the first chunk: nothing
    needs the gradient entering it, and its S_in is zero) and G B and
    G^T xb (not in the last chunk without ``dstate``: G is zero there)."""
    nc = -(-l // c)
    total = 0
    for k, l0 in enumerate(range(0, l, c)):
        r = min(c, l - l0)
        tri = r * (r + 1) // 2
        states = 2 * (k > 0) + 2 * (k < nc - 1 or dstate)
        total += 2 * tri * n + h * (2 * tri * p + states * r * p * n)
    return 2 * b * total


def ssd_bwd(b: int, l: int, h: int, p: int, n: int, c: int, es: int,
            dstate: bool = False) -> tuple[int, int]:
    """K4's backward: :func:`ssd_bwd_flops`; x and dy read and dx
    written, B and C read and dB and dC written, in the operands' dtype;
    dt and A read and their gradients written in fp32 (and the final
    state's gradient read, when given)."""
    nbytes = (3 * b * l * h * p + 4 * b * l * n) * es \
        + 2 * (b * l * h + h) * 4 + (4 * b * h * p * n if dstate else 0)
    return ssd_bwd_flops(b, l, h, p, n, c, dstate), nbytes
