"""PyTorch port of ``repro`` for an NVIDIA H100.

The RegTop-k trainer (the dense LM family, the compact sparsifier
runtime, the four wire codecs, the one-card reductions under worker or
coordinate weighting, the alpha–beta cost model, Adam) with the fused
select→encode fastpath, the paper's simulator, the sort-free selections,
and the hand-written CUDA kernels behind them (``kernels``). Module names
mirror ``repro``'s, so the counterpart of ``repro.core.compact`` is
``repro_torch.core.compact``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU each kernel wrapper computes its plain PyTorch version.
"""
