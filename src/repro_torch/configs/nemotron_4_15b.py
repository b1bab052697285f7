"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU MLP.  [arXiv:2402.16819]"""
from .base import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    n_layers=32,
    d_model=6144,
    d_ff=24_576,
    vocab=256_000,
    attention=AttentionSpec(
        kind="gqa", n_heads=48, n_kv_heads=8, head_dim=128,
        rope_theta=10_000.0,
    ),
    activation="relu2",          # squared ReLU
    source="arXiv:2402.16819",
)
