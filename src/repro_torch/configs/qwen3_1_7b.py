"""qwen3-1.7b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B]"""
from .base import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    n_layers=28,
    d_model=2048,
    d_ff=6144,
    vocab=151_936,
    attention=AttentionSpec(
        kind="gqa", n_heads=16, n_kv_heads=8, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
    ),
    activation="silu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
