"""Operations and bytes of the served pipeline's work, from its shapes,
and the peaks they are held against.

Counts are the algorithm's: 2 FLOPs a multiply-add of every product,
attention's two products (QK^T and PV, 4 B Sq Sk H d), and the bytes of
each attention's inputs read once and its output written once, in
float32.  Element-wise work (norms, softmax, activations) is not
counted.
"""
from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA H100 SXM (data sheet, dense): the tensor cores' TF32 rate over
#: three, the ceiling for float32-accurate products (split-TF32), and
#: HBM3 bandwidth; at the card's full 700 W power limit
PEAK_FP32_ACCURATE_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12
F32 = 4
PROMPT_LEN = 77


@dataclass(frozen=True)
class Work:
    """Product FLOPs (``linear``), attention FLOPs and the least time
    attention can take at the peaks (``attn_bound_s``)."""
    linear: float = 0.0
    attn: float = 0.0
    attn_bound_s: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.linear + o.linear, self.attn + o.attn,
                    self.attn_bound_s + o.attn_bound_s)

    def scaled(self, k: float) -> "Work":
        return Work(self.linear * k, self.attn * k, self.attn_bound_s * k)

    @property
    def total(self) -> float:
        return self.linear + self.attn


def attention(batch: int, sq: int, sk: int, heads: int, kv_heads: int,
              d: int) -> Work:
    """One attention call: q (B, Sq, H, d), k/v (B, Sk, KV, d)."""
    flops = 4.0 * batch * sq * sk * heads * d
    nbytes = F32 * batch * d * (2 * sq * heads + 2 * sk * kv_heads)
    bound = max(flops / PEAK_FP32_ACCURATE_FLOPS, nbytes / PEAK_HBM_BYTES)
    return Work(attn=flops, attn_bound_s=bound)


def denoise(m: dict, n: int, batch: int = 1,
            text_len: int = PROMPT_LEN) -> Work:
    """One DiT forward over ``batch`` members of ``n`` tokens each."""
    d, h, kv, hd, ff = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    pd = m["patch_size"] ** 2 * m["in_channels"]
    qo, kvw = h * hd, kv * hd
    per_layer = (2.0 * n * d * (2 * qo + 2 * kvw)       # self q, k, v, o
                 + 2.0 * n * d * 2 * qo                  # cross q, o
                 + 2.0 * text_len * d * 2 * kvw          # cross k, v
                 + 2.0 * n * d * 3 * ff                  # SwiGLU
                 + 2.0 * d * 6 * d)                      # adaLN modulation
    head = (2.0 * n * pd * d + 2.0 * 256 * d + 2.0 * d * d
            + 2.0 * text_len * m["cond_dim"] * d
            + 2.0 * d * 2 * d + 2.0 * n * d * pd)
    lin = Work(linear=batch * (m["num_layers"] * per_layer + head))
    att = (attention(batch, n, n, h, kv, hd)
           + attention(batch, n, text_len, h, kv, hd))
    return lin + att.scaled(m["num_layers"])


def encode(t: dict, text_len: int = PROMPT_LEN) -> Work:
    """The text encoder over one prompt."""
    d, h, kv, hd, ff = (t["d_model"], t["num_heads"], t["num_kv_heads"],
                        t["head_dim"], t["d_ff"])
    per_layer = (2.0 * text_len * d * (2 * h * hd + 2 * kv * hd)
                 + 2.0 * text_len * d * 3 * ff)
    return (Work(linear=t["num_layers"] * per_layer)
            + attention(1, text_len, text_len, h, kv, hd)
            .scaled(t["num_layers"]))


def decode(v: dict, in_channels: int, latent_px: int) -> Work:
    """The VAE decoder over ``latent_px`` latent pixels (frames x h x w)
    of ``in_channels`` channels."""
    hid = v["hidden"]
    px = latent_px
    return Work(linear=2.0 * px * in_channels * hid
                + 2.0 * px * 9 * hid * 4 * hid
                + 2.0 * 4 * px * 9 * hid * 4 * hid
                + 2.0 * 16 * px * 9 * hid * 12)


def span_work(config: dict, span) -> Work:
    """The work of one pipeline call of the record (a :class:`Span`)."""
    m = config["model"]
    if span.kind == "denoise":
        return denoise(m, span.tokens, batch=len(span.members))
    if span.kind == "encode":
        return encode(config["text_encoder"])
    return decode(config["vae"], m["in_channels"],
                  span.tokens * m["patch_size"] ** 2)
