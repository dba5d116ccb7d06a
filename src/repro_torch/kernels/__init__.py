"""Hand-written CUDA kernels for Hopper and their wrappers.

* ``fused_encode`` — one-pass score→select candidates (``csrc/fused_encode.cu``)
* ``ops``          — the layout contract and the fused select→encode pipeline
* ``build``        — nvcc build of ``csrc/`` and ctypes loading
"""
