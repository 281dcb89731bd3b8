"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408, vocab 151936,
60 routed experts top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    moe_renormalize=False,   # qwen2-moe does not renormalise top-k gates
    vocab_size=151936,
)
