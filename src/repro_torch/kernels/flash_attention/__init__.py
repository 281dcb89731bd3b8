from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref"]
