"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

The EnCodec tokenizer / conditioning encoder is a STUB, as in the JAX
package: the conditioning frame embeddings (64 frames, [B, 64, d_model])
are given precomputed and prepended to the audio-token stream
(``data/pipeline.py`` draws them from a seed).  The port's copy of the
JAX package's ``configs/musicgen_large.py``
(``tests/test_torch_frontends.py`` pins it field by field).
"""
from .base import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab=2048,                 # EnCodec codebook size
    attention=AttentionSpec(
        kind="gqa", n_heads=32, n_kv_heads=32, head_dim=64,
        rope_theta=10_000.0,
    ),
    activation="gelu",
    frontend="audio",
    n_prefix_tokens=64,         # conditioning frame embeddings (stub)
    source="arXiv:2306.05284",
)
