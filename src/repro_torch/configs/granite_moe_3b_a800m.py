"""granite-moe-3b-a800m — IBM Granite 3.0 MoE.

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512, vocab 49155,
40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,          # kept for reference; experts use moe_d_ff
    moe_d_ff=512,
    n_experts=40,
    top_k=8,
    vocab_size=49155,
    tie_embeddings=True,
)
