"""dbrx-132b [moe] — 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]"""
from .base import AttentionSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    d_ff=10_752,
    vocab=100_352,
    attention=AttentionSpec(
        kind="gqa", n_heads=48, n_kv_heads=8, head_dim=128,
        rope_theta=500_000.0,
    ),
    activation="silu",
    moe=MoESpec(n_experts=16, top_k=4, n_shared=0, d_ff_expert=10_752),
    source="hf:databricks/dbrx-base",
)
