"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision frontend.
[hf:microsoft/Phi-3-vision-128k-instruct]

The CLIP ViT-L/14-336 encoder and projector are a STUB, as in the JAX
package: the patch embeddings (576 patches, already projected to
d_model) are given precomputed and prepended to the token stream
(``data/pipeline.py`` draws them from a seed).  Head dim 96 runs on B6's
(96, 96) instance.  The port's copy of the JAX package's
``configs/phi_3_vision_4_2b.py`` (``tests/test_torch_frontends.py`` pins
it field by field).
"""
from .base import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32_064,
    attention=AttentionSpec(
        kind="gqa", n_heads=32, n_kv_heads=32, head_dim=96,
        rope_theta=10_000.0,
    ),
    activation="silu",
    frontend="vision",
    n_prefix_tokens=576,        # ViT-L/14 @ 336px -> 24x24 patches
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
