"""Plain PyTorch versions of the kernels in csrc/ (the allclose targets).

Each follows its JAX oracle in ``repro/kernels/ref.py`` line for line:
softmax and normalisation run in fp32 and the result is cast back to the
input's dtype.  The wrappers in :mod:`repro_torch.kernels.ops` run these
for CPU tensors only; on the card they are what the kernels are held to.

The backward kernels of K2, K1 and K4 have plain versions here too
(:func:`attention_bwd_ref`, :func:`adaln_bwd_ref`, :func:`ssd_bwd_ref`):
the closed-form gradients, in fp32, of :func:`attention_ref`,
:func:`adaln_ref` and :func:`ssd_ref`, which is what ``jax.vjp`` of the
JAX oracles computes.  The JAX package has no
backward kernel (it trains through its jnp path).
"""
from __future__ import annotations

import torch


def linear_ref(x, w):
    """``x @ w``: x (..., K) and w (K, N) -> (..., N)."""
    return x @ w


def _scores(q, k, causal: bool):
    """fp32 scores q.k^T / sqrt(d), (B, H, Sq, Sk), with k's heads
    repeated over their GQA group and the causal mask filled with -1e30."""
    sq, h, d = q.shape[1:]
    k = torch.repeat_interleave(k, h // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        mask = torch.tril(torch.ones((sq, k.shape[1]), dtype=torch.bool,
                                     device=q.device),
                          diagonal=k.shape[1] - sq)
        s = torch.where(mask[None, None], s, -1e30)
    return s


def attention_ref(q, k, v, *, causal: bool = False):
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d). fp32 softmax."""
    v = torch.repeat_interleave(v, q.shape[2] // v.shape[2], dim=2)
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = False):
    """The log-sum-exp of each query row's scaled scores, (B, H, Sq) fp32,
    in natural-log units: what K2's forward writes for its backward."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = False):
    """Gradients (dq, dk, dv) of :func:`attention_ref` for the output
    gradient ``do``, in closed form (FlashAttention-2's), in fp32:

        P = exp(S - lse),  D = rowsum(dO * O),  dS = P * (dO V^T - D),
        dQ = scale dS K,   dK = scale dS^T Q,   dV = P^T dO,

    with S the masked scaled scores of :func:`_scores` (masked entries
    give P = 0) and dK, dV summed over each KV head's query group.
    o: the forward's output; lse: (B, H, Sq) fp32.  Each gradient comes
    back in its operand's dtype."""
    b, sk, kv, d = k.shape
    group = q.shape[2] // kv
    scale = d ** -0.5
    p = torch.exp(_scores(q, k, causal) - lse[..., None].float())
    dof = do.float()
    kr = torch.repeat_interleave(k, group, dim=2).float()
    vr = torch.repeat_interleave(v, group, dim=2).float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vr) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kv, group, d).sum(3)
    dv = dv.reshape(b, sk, kv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def adaln_ref(x, shift=None, scale=None, gate=None, residual=None, *,
              ln: bool = True, eps: float = 1e-6):
    """adaLN-Zero modulate, matching csrc/adaln.cu's variants.

    x/residual: (B, N, D); shift/scale/gate: (B, D).
    Full form returns residual + gate * (LN(x) * (1 + scale) + shift);
    omit gate/residual for the pre-branch modulated norm, omit
    shift/scale with ``ln=False`` for the bare gated residual.
    """
    out = x.float()
    if ln:
        mu = out.mean(-1, keepdim=True)
        var = ((out - mu) ** 2).mean(-1, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + eps)
    if shift is not None:
        out = out * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    if gate is not None:
        out = residual.float() + gate.float()[:, None] * out
    return out.to(x.dtype)


def adaln_bwd_ref(x, shift=None, scale=None, gate=None, dy=None, *,
                  ln: bool = True, eps: float = 1e-6):
    """Gradients of :func:`adaln_ref` for the output gradient ``dy``, in
    closed form, in fp32: (dx, dshift, dscale, dgate, dresidual), None
    where the operand is absent.  With x^ = LN(x) (or x), the branch
    y = x^ (1 + scale) + shift (or x^) and dy' = dy * gate (or dy):

        dresidual = dy,  dgate = sum_n dy * y,  dshift = sum_n dy',
        dscale = sum_n dy' * x^,  dx^ = dy' (1 + scale),
        dx = rstd (dx^ - mean(dx^) - x^ mean(dx^ x^))   (LN; else dx^),

    the sums over the N tokens of each batch row, the means over D.
    Each gradient comes back in x's dtype."""
    dt = x.dtype
    xf, g = x.float(), dy.float()
    if ln:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xh = (xf - mu) * rstd
    else:
        xh = xf
    dshift = dscale = dgate = dres = None
    if gate is not None:
        y = xh if shift is None else \
            xh * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
        dgate = (g * y).sum(1).to(dt)
        dres = dy.to(dt)
        g = g * gate.float()[:, None]
    if shift is not None:
        dshift = g.sum(1).to(dt)
        dscale = (g * xh).sum(1).to(dt)
        g = g * (1.0 + scale.float()[:, None])
    if ln:
        g = rstd * (g - g.mean(-1, keepdim=True)
                    - xh * (g * xh).mean(-1, keepdim=True))
    return g.to(dt), dshift, dscale, dgate, dres


def splice_attention_ref(q, k_stale, v_stale, k_fresh, v_fresh, *,
                         offset: int, causal: bool = False):
    """Materialize-then-attend version of the §11 cache-splice kernel:
    overwrite rows [offset, offset+L) of the stale snapshot with the
    fresh local shard, then run plain attention."""
    n = k_fresh.shape[1]
    k = k_stale.clone()
    v = v_stale.clone()
    k[:, offset:offset + n] = k_fresh.to(k.dtype)
    v[:, offset:offset + n] = v_fresh.to(v.dtype)
    return attention_ref(q, k, v, causal=causal)


def ssd_ref(x, dt, A, B, C, *, chunk: int = 0):
    """Sequential (non-chunked) SSD recurrence, in fp32.

    x: (b, l, h, p); dt: (b, l, h); A: (h,); B/C: (b, l, n).
    Returns (y (b, l, h, p) in x's dtype, final_state (b, h, p, n) fp32).
    ``chunk`` is accepted for the kernel's signature and ignored: the
    recurrence has no chunks, so any ``l`` is taken.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    out_dtype = x.dtype
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A[None])                          # (b,h)
        dBx = torch.einsum("bn,bhp->bhpn", B[:, t],
                           x[:, t] * dt[:, t, :, None])
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], state))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, h, p))
    return y.to(out_dtype), state


def _ssd_chunks(x, dt, A, B, C, more, chunk: int):
    """The start that the chunked plain versions share: the operands in
    fp32, the sequence zero-filled past ``l`` to ``nc`` chunks (as the
    kernels' masked loads: dt = x = B = C = 0 leaves ``cum`` and the state
    as they are) and cut into them, then :func:`ssd_chunked_ref`'s stages
    1-2.  ``more``: tensors of x's layout cut the same way.  Returns xc
    (b, nc, c, h, p), dtc (b, nc, h, c), Bc and Cc (b, nc, c, n), ``more``
    cut, cum (b, nc, h, c), S_in (b, nc, h, p, n) and the final state."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    more = [t.float() for t in more]
    if pad:
        x, dt, B, C, *more = (
            torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
            for t in (x, dt, B, C, *more))
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).transpose(2, 3)        # (b, nc, h, c)
    Bc, Cc = B.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n)
    more = [t.reshape(b, nc, chunk, h, p) for t in more]

    # 1. cum and the chunk-local states
    cum = torch.cumsum(dtc * A[:, None], dim=-1)              # (b, nc, h, c)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    states = torch.einsum("bchj,bcjhp,bcjn->bchpn", w, xc, Bc)
    # 2. the pass of states across chunks
    s_in = torch.empty_like(states)
    state = states.new_zeros((b, h, p, n))
    for k in range(nc):
        s_in[:, k] = state
        state = torch.exp(cum[:, k, :, -1])[..., None, None] * state \
            + states[:, k]
    return xc, dtc, Bc, Cc, more, cum, s_in, state


def ssd_chunked_ref(x, dt, A, B, C, *, chunk: int):
    """The chunk-parallel SSD of ``csrc/ssd.cu``, stage by stage, in fp32.

    Same operands and results as :func:`ssd_ref`.  The sequence is cut
    into ``nc`` chunks of ``chunk`` rows, the last zero-filled past ``l``
    as the kernel's masked loads do (dt = x = B = C = 0 leaves ``cum``
    and the state as they are), and the stage kernels' steps run in turn:
      1. ssd_chunk_state_mma: ``cum``, the in-chunk cumulative sum of dt*A,
         and the chunk-local state
         S_c = sum_j exp(cum_last - cum_j) (x_j dt_j) (x) B_j;
      2. ssd_state_pass: S_in[0] = 0, S_in[c+1] = exp(cum_last_c) S_in[c]
         + S_c, the last of which is the final state;
      3. ssd_cb_mma: C B^T once per (batch, chunk), shared by every head;
      4. ssd_chunk_scan_mma: y_i = sum_{j<=i} CB_ij exp(cum_i - cum_j)
         dt_j x_j + exp(cum_i) (C_i . S_in), the decay masked to -1e30
         before the exp.
    Nothing on the serving path calls this: it documents the kernel's
    algorithm and is a test oracle for it.
    """
    b, l, h, p = x.shape
    xc, dtc, Bc, Cc, _, cum, s_in, state = _ssd_chunks(x, dt, A, B, C, (),
                                                       chunk)
    # 3. C B^T once per (batch, chunk)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    # 4. the chunk scan
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]               # (b,nc,h,i,j)
    decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    y = torch.einsum("bcij,bchij,bchj,bcjhp->bcihp", cb, decay, dtc, xc)
    y = y + torch.einsum("bcin,bchi,bchpn->bcihp", Cc, torch.exp(cum), s_in)
    y = y.reshape(b, -1, h, p)[:, :l]
    return y.to(x.dtype), state


def ssd_bwd_ref(x, dt, A, B, C, dy, dstate=None, *, chunk: int):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`ssd_ref` for the output
    gradient ``dy`` (b, l, h, p) and the final state's ``dstate`` (b, h,
    p, n; None: zero), in closed form, in fp32, chunked as
    :func:`ssd_chunked_ref` (the last chunk zero-filled past ``l``).
    Each gradient comes back in its operand's shape and dtype.

    Per (batch, chunk, head), with xb = x dt, cum the in-chunk cumulative
    sum of dt A, L_ij = exp(cum_i - cum_j) for i >= j (the decay masked to
    -1e30 before the exp, as the forward), S_in[c] the state entering
    chunk c (:func:`ssd_chunked_ref`'s stages 1-2) and, as ``csrc/
    ssd_bwd.cu`` computes them:
      1. reverse state pass: G[nc] = dstate, G[c] = exp(cum_last,c)
         G[c+1] + sum_{i in c} exp(cum_i) dy_i (x) C_i; G[c+1] is the
         gradient of chunk c's outgoing state;
      2. dxb_j = sum_{i>=j} (C_i . B_j) L_ij dy_i
         + exp(cum_last - cum_j) G[c+1] B_j; dx = dxb dt, and ddt gets
         x . dxb;
      3. dC_i = sum_h [sum_{j<=i} L_ij (dy_i . xb_j) B_j
         + exp(cum_i) S_in[c]^T dy_i],
         dB_j = sum_h [sum_{i>=j} L_ij (dy_i . xb_j) C_i
         + exp(cum_last - cum_j) G[c+1]^T xb_j]
         (B and C are shared by every head);
      4. dcum, from each exp: the intra terms T_ij = (C_i . B_j) L_ij
         (dy_i . xb_j), +T_ij on cum_i and -T_ij on cum_j;
         exp(cum_i) dy_i . (S_in C_i) on cum_i; W_j = exp(cum_last -
         cum_j) xb_j . (G[c+1] B_j), -W_j on cum_j and +W_j on cum_last;
         exp(cum_last) <S_in, G[c+1]> on cum_last;
      5. da, dcum's reverse cumulative sum within the chunk (over the whole
         padded chunk, so that the padded last row's cum_last reaches the
         real rows); ddt += A da and dA = sum_{b, l} dt da.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    dtypes = (x.dtype, dt.dtype, A.dtype, B.dtype, C.dtype)
    # the forward's cum and S_in (stages 1-2 of ssd_chunked_ref)
    xc, dtc, Bc, Cc, (dyc,), cum, s_in, _ = _ssd_chunks(x, dt, A, B, C,
                                                        (dy,), chunk)
    nc = cum.shape[1]
    A = A.float()
    xb = xc * dtc.transpose(2, 3)[..., None]                 # (b,nc,c,h,p)
    ec = torch.exp(cum)
    ed = torch.exp(cum[..., -1:] - cum)
    # 1. the reverse state pass: gn[:, c] = G[c+1]
    q = torch.einsum("bchi,bcihp,bcin->bchpn", ec, dyc, Cc)
    gn = torch.empty_like(q)
    g = q.new_zeros((b, h, p, n)) if dstate is None else dstate.float()
    for k in reversed(range(nc)):
        gn[:, k] = g
        g = torch.exp(cum[:, k, :, -1])[..., None, None] * g + q[:, k]
    # the intra-chunk products
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=cum.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]               # (b,nc,h,i,j)
    decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    pm = decay * torch.einsum("bcihp,bcjhp->bchij", dyc, xb)  # L (dy . xb)
    # 2. dxb, dx and ddt through xb
    dxb_state = torch.einsum("bcjn,bchpn->bcjhp", Bc, gn)
    dxb = torch.einsum("bcij,bchij,bcihp->bcjhp", cb, decay, dyc) \
        + ed.transpose(2, 3)[..., None] * dxb_state
    dx = dxb * dtc.transpose(2, 3)[..., None]
    ddt = (xc * dxb).sum(-1).transpose(2, 3)                  # (b, nc, h, c)
    # 3. dC and dB, summed over heads
    dC_state = ec[..., None] * torch.einsum("bcihp,bchpn->bchin", dyc, s_in)
    dC = torch.einsum("bchij,bcjn->bcin", pm, Bc) + dC_state.sum(2)
    dB = torch.einsum("bchij,bcin->bcjn", pm, Cc) + torch.einsum(
        "bchj,bcjhp,bchpn->bcjn", ed, xb, gn)
    # 4. dcum
    t = cb[:, :, None] * pm
    w = ed * torch.einsum("bcjhp,bcjhp->bchj", xb, dxb_state)
    dcum = t.sum(-1) - t.sum(-2) - w \
        + torch.einsum("bchin,bcin->bchi", dC_state, Cc)
    dcum[..., -1] += w.sum(-1) + torch.exp(cum[..., -1]) * (
        s_in * gn).sum((-1, -2))
    # 5. da, then ddt and dA through cum
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + A[:, None] * da
    dA = (dtc * da).sum((0, 1, 3))

    def unchunk(t, *tail):
        return t.reshape(b, -1, *tail)[:, :l]
    grads = (unchunk(dx, h, p), unchunk(ddt.transpose(2, 3), h), dA,
             unchunk(dB, n), unchunk(dC, n))
    return tuple(g.to(d) for g, d in zip(grads, dtypes))
