"""PyTorch + CUDA port of the FPCA reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s module layout so each module has an obvious
counterpart.  It imports ``torch`` only: the JAX package stays the reference
the tests hold this one against.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.

Main path::

    from repro_torch import fpca
    from repro_torch.configs import fpca_cnn

    m = fpca.compile(fpca_cnn.make_model_program(), weights=kernel,
                     head_params=head_params)
    logits = m.run(frames)              # (B, 2), through the CUDA kernel
"""
