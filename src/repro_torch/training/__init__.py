"""Training: AdamW, the microbatched train step, checkpoints."""
