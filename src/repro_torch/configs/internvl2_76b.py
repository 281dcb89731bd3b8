"""internvl2-76b — InternVL2 (InternViT frontend + LLaMA-arch 70B-class LM).

80L d_model=8192 64H (GQA kv=8) d_ff=28672, vocab 128256.
Vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (InternViT hidden size 3200); the projector MLP
is part of the model.  An FPCA patch-embed frontend is available as an
opt-in for the real-image path (DESIGN.md §4). [arXiv:2404.16821; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    frontend_dim=3200,
    frontend_tokens=256,
)
