"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 160-expert top-6 MoE with
2 shared experts.  [arXiv:2405.04434]

Assignment line: 60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400,
MoE 160e top-6.  The assigned d_ff=1536 is the *per-expert* hidden size
(DeepSeek-V2 moe_intermediate_size); the single leading dense layer uses
the model-card intermediate_size of 12288.
"""
from .base import AttentionSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    d_ff=12288,                 # dense FFN width (layer 0)
    vocab=102_400,
    attention=AttentionSpec(
        kind="mla",
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,           # qk_nope + qk_rope
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
    ),
    activation="silu",
    moe=MoESpec(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    n_dense_layers=1,
    source="arXiv:2405.04434",
)
