from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

__all__ = ["ssd_chunked", "ssd_intra_chunk_cuda", "ssd_intra_chunk_ref"]
