from repro_torch.kernels.flash_attention.bwd import (
    flash_attention_bwd_cuda,
    flash_attention_dkdv_cuda,
    flash_attention_dq_cuda,
)
from repro_torch.kernels.flash_attention.bwd_ref import flash_attention_bwd_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = [
    "flash_attention_cuda",
    "flash_attention_ref",
    "flash_attention_bwd_cuda",
    "flash_attention_bwd_ref",
    "flash_attention_dq_cuda",
    "flash_attention_dkdv_cuda",
]
