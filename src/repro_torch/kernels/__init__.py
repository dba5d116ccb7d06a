"""Hand-written CUDA kernels for Hopper and their wrappers.

* ``fused_encode``   — one-pass score→select candidates (``csrc/fused_encode.cu``)
* ``regtopk_score``  — the Alg. 2 score as one elementwise pass
  (``csrc/regtopk_score.cu``)
* ``threshold_topk`` — count-above and global-max passes and the sort-free
  bisection they drive (``csrc/threshold_topk.cu``)
* ``block_topk``     — per-tile top-m candidates and the hierarchical top-k
  (``csrc/block_topk.cu``)
* ``ops``            — the layout contract and the public wrappers
* ``build``          — nvcc build of ``csrc/`` and ctypes loading
"""
