"""seamless-m4t-medium — Meta SeamlessM4T (medium), enc-dec multimodal.

12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096, vocab 256206.
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (assignment requirement). [arXiv:2308.11596; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    frontend_dim=1024,      # precomputed speech-frame embedding width
)
