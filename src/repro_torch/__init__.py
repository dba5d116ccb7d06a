"""PyTorch port of ``repro`` for an NVIDIA H100.

Slice 1 covers the RegTop-k trainer with the fused select→encode fastpath:
the dense LM family (``paper-resnet-proxy``), the compact sparsifier
runtime, the ``coo_fp32`` codec, the one-card ``sparse_allgather``
aggregation, Adam, and the hand-written CUDA kernel behind
``kernels.fused_encode``. Module names mirror ``repro``'s, so the
counterpart of ``repro.core.compact`` is ``repro_torch.core.compact``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU each kernel wrapper computes its plain PyTorch version.
"""
