"""deepseek-v2-236b [moe] — arXiv:2405.04434.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400; MLA kv_lora=512,
2 shared + 160 routed experts top-6; first layer dense (d_ff=12288).
"""
from repro_torch.configs.base import MLA, MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,           # MLA: per-head latent decode, kv=heads logically
    head_dim=128,
    d_ff=12288,                 # dense-layer FFN width
    vocab_size=102400,
    attention=MLA,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        num_shared_experts=2,
        expert_d_ff=1536,
        num_dense_layers=1,
    ),
)
