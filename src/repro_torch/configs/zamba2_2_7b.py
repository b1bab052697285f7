"""zamba2-2.7b [hybrid] — Mamba2 backbone + one SHARED attention block
applied every 6 SSM layers.  [arXiv:2411.15242]

The port's copy of the JAX package's ``configs/zamba2_2_7b.py``
(``tests/test_torch_hybrid.py`` pins it field by field)."""
from .base import AttentionSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10_240,                # shared-block MLP width
    vocab=32_000,
    attention=AttentionSpec(
        kind="gqa", n_heads=32, n_kv_heads=32, head_dim=80,
        rope_theta=10_000.0,
    ),
    activation="gelu",
    ssm=SSMSpec(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)
