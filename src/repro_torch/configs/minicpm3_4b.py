"""minicpm3-4b [dense] — MLA attention.  [hf:openbmb/MiniCPM3-4B]"""
from .base import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab=73_448,
    attention=AttentionSpec(
        kind="mla",
        n_heads=40,
        n_kv_heads=40,
        head_dim=96,            # qk_nope + qk_rope
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        rope_theta=10_000.0,
    ),
    activation="silu",
    source="hf:openbmb/MiniCPM3-4B",
)
