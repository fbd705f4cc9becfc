"""Config system for the repro framework.

One :class:`ModelConfig` dataclass covers every supported family
(dense / MoE / SSM / hybrid / enc-dec / VLM / DiT).  Full-size configs are
only ever touched through ``jax.eval_shape`` / ``ShapeDtypeStruct`` paths
(the multi-pod dry-run); smoke tests call :meth:`ModelConfig.reduced` to get
a tiny config of the same family that runs a real step on CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Attention / layer-pattern vocabulary
# ---------------------------------------------------------------------------
# attention kinds
FULL = "full"              # full bidirectional/causal softmax attention
SWA = "swa"                # sliding-window attention
MLA = "mla"                # DeepSeek multi-head latent attention
NONE = "none"              # attention-free (SSM) layer

# layer kinds used in `layer_pattern` entries
ATTN = "attn"              # attention + MLP block
MOE = "moe"                # attention + MoE block
SSM_L = "ssm"              # Mamba2 SSD block
SHARED_ATTN = "shared_attn"  # Zamba2-style shared attention block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    expert_d_ff: int = 0          # per-expert FFN hidden dim (0 -> use d_ff)
    # first N layers stay dense (DeepSeek-V2 uses 1)
    num_dense_layers: int = 0
    router_jitter: float = 0.0
    # dispatch grouping: set to #data-shards by the step factories so the
    # capacity buffer stays sharded with the tokens (GShard-style groups)
    num_groups: int = 1
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 -> no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N (SSD state size)
    head_dim: int = 64            # P (channels per SSD head)
    num_heads: int = 0            # 0 -> derived = d_inner // head_dim
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 128              # SSD chunk length
    conv_kernel: int = 4
    # intra-chunk compute dtype ("float32" | "bfloat16"): dt/A/cumsum stay
    # fp32; bfloat16 halves the dominant (b,c,L,L,hb) HBM traffic
    intra_dtype: str = "float32"
    # heads per intra-chunk block (VMEM working-set knob)
    head_block: int = 4


@dataclass(frozen=True)
class DiTConfig:
    """Latent-diffusion transformer specifics (paper's own model family)."""
    patch_size: int = 2
    in_channels: int = 16         # latent channels
    cond_dim: int = 1024          # text-conditioning embedding dim
    num_steps: int = 50           # default denoising steps
    # video: frames in latent space (1 -> image model)
    latent_frames: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense|moe|ssm|hybrid|encdec|vlm|dit
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0             # 0 -> d_model // num_heads
    attention: str = FULL         # full | swa | mla
    window: int = 4096            # SWA window size
    # local:global interleave, e.g. gemma3 = 5 local : 1 global.
    # (local_layers, global_layers) per super-block; (0, 0) -> uniform.
    local_global: tuple[int, int] = (0, 0)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # sub-configs (None when family doesn't use them)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    dit: Optional[DiTConfig] = None
    # hybrid (zamba2): a shared attention block is applied every
    # `shared_attn_every` ssm layers (0 -> never)
    shared_attn_every: int = 0
    # enc-dec
    num_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: "none"|"audio_frames"|"image_patches"
    frontend: str = "none"
    frontend_seq: int = 0         # frontend token count (e.g. 1500 audio frames)
    max_seq_len: int = 131072
    # fully unroll lax.scan loops (dry-run cost extraction only: XLA's
    # cost_analysis counts while-loop bodies once, so rooflines are derived
    # from small unrolled variants and extrapolated linearly in depth)
    scan_unroll: bool = False
    # route the model hot path through the Pallas kernel layer
    # (kernels/ops.py): fused adaLN-modulate, flash attention, and the
    # §11 cache-splice kernel.  Numerics change within tolerance only —
    # scheduling (control-plane traces) is bit-identical (DESIGN.md §12).
    # Overridable at runtime via the REPRO_USE_PALLAS env var.
    use_pallas: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic attention -> eligible for the long_500k shape."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attention == SWA:
            return True
        if self.local_global != (0, 0):
            return True          # mostly-local layers dominate (gemma3)
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode step

    # ------------------------------------------------------------------
    def reduced(self, **overrides: Any) -> "ModelConfig":
        """Tiny config of the same family for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 1,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=min(self.window, 64),
            max_seq_len=1024,
            frontend_seq=min(self.frontend_seq, 16) if self.frontend_seq else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
        )
        if self.local_global != (0, 0):
            kw["local_global"] = (1, 1)
            kw["num_layers"] = 2
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=128,
                num_dense_layers=min(self.moe.num_dense_layers, 1),
            )
        if self.mla is not None:
            kw["mla"] = replace(
                self.mla, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32, q_lora_rank=0)
            kw["head_dim"] = 32
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=16, head_dim=16,
                                num_heads=0, chunk=16)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
            kw["num_layers"] = 4
        if self.dit is not None:
            kw["dit"] = replace(self.dit, cond_dim=64, num_steps=4)
        kw.update(overrides)
        return replace(self, **kw)

    def with_(self, **overrides: Any) -> "ModelConfig":
        return replace(self, **overrides)

    # ------------------------------------------------------------------
    # parameter counting (for roofline MODEL_FLOPS = 6·N·D)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; `active_only` counts only routed
        experts that fire per token (for MoE 6·N_active·D rooflines)."""
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attention == MLA:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * (m.kv_lora_rank + m.qk_rope_head_dim)          # kv down
                p += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                if m.q_lora_rank:
                    p += d * m.q_lora_rank + m.q_lora_rank * h * qk_hd
                else:
                    p += d * h * qk_hd
                p += h * m.v_head_dim * d                              # o_proj
                return p
            return d * h * hd + 2 * d * kv * hd + h * hd * d           # q,k,v,o

        def mlp_params(dff: int) -> int:
            return 3 * d * dff                                          # SwiGLU

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = s.num_heads or (d_in // s.head_dim)
            # in_proj produces [z, x, B, C, dt]
            proj_out = 2 * d_in + 2 * s.state_dim + nheads
            return d * proj_out + d_in * d + s.conv_kernel * (
                d_in + 2 * s.state_dim) + 2 * nheads

        total = embed
        for kind in self.layer_kinds():
            if kind == SSM_L:
                total += ssm_params()
            elif kind in (ATTN, SHARED_ATTN):
                total += attn_params() + mlp_params(self.d_ff)
            elif kind == MOE:
                m = self.moe
                eff = m.expert_d_ff or self.d_ff
                n_e = (m.top_k + m.num_shared_experts) if active_only \
                    else (m.num_experts + m.num_shared_experts)
                total += attn_params() + n_e * mlp_params(eff) \
                    + d * m.num_experts                              # router
        for _ in range(self.num_encoder_layers):
            total += attn_params() + mlp_params(self.d_ff)
            if self.cross_attention:
                total += attn_params()
        return int(total)

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer kind list for the decoder stack."""
        kinds: list[str] = []
        if self.family == "ssm":
            return [SSM_L] * self.num_layers
        if self.family == "hybrid":
            for i in range(self.num_layers):
                kinds.append(SSM_L)
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    kinds.append(SHARED_ATTN)
            return kinds
        base = MOE if (self.moe is not None) else ATTN
        if self.moe is not None and self.moe.num_dense_layers:
            kinds = [ATTN] * self.moe.num_dense_layers + \
                [base] * (self.num_layers - self.moe.num_dense_layers)
        else:
            kinds = [base] * self.num_layers
        return kinds


# ---------------------------------------------------------------------------
# Input-shape cells (assigned shapes; every arch gets all four, some skipped)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch x shape) is a live dry-run cell; returns (ok, reason)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""
