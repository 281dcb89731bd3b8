"""h2o-danube-1.8b — H2O.ai Danube (llama+mistral mix, sliding window).

24L d_model=2560 32H (GQA kv=8) d_ff=6912, vocab 32000, SWA window 4096.
[arXiv:2401.16818; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    window=4096,
)
