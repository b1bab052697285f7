"""rwkv6-7b [ssm] — "Finch", attention-free, data-dependent decay WKV.
[arXiv:2404.05892]"""
from .base import AttentionSpec, ModelConfig, RWKVSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    d_ff=14_336,
    vocab=65_536,
    attention=AttentionSpec(kind="none", n_heads=64, n_kv_heads=64,
                            head_dim=64),
    activation="relu2",          # rwkv channel-mix uses squared relu
    # chunk=64: chunked-parallel WKV, one WKV6 chunk kernel launch per
    # 64 tokens and layer
    rwkv=RWKVSpec(head_dim=64, decay_lora=64, mix_lora=32, chunk=64),
    source="arXiv:2404.05892",
)
