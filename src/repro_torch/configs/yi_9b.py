"""yi-9b — 01.AI Yi (llama-arch GQA).

48L d_model=4096 32H (GQA kv=4) d_ff=11008, vocab 64000.
[arXiv:2403.04652; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)
