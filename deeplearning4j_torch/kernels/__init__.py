"""Hand-written CUDA kernels of the port, built for Hopper at first use.

``csrc/`` holds one ``.cu`` per kernel with a plain C interface;
``_build.py`` compiles it with nvcc and loads it through ctypes. The Python
wrapper of each kernel lives beside the op it serves, with its plain PyTorch
version and its launch count:

- ``flash_fwd_sm90`` — attention forward (K1) in bf16 at head dims 64 and
  128 (TMA, wgmma, warp specialised), and ``flash_fwd`` — K1 in f32 and in
  bf16 at 16 and 32; both wrapped by ``ops.flash_attention.flash_fwd_cuda``;
- ``flash_bwd_sm90`` — attention backward (K2, K3) in bf16 at head dim 64
  (TMA, wgmma, warp specialised), and ``flash_bwd`` — K2, K3 in f32 and in
  bf16 at 16, 32 and 128, and the column broadcast probe (K5); wrapped by
  ``ops.flash_attention.flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda`` and
  ``column_broadcast_cuda``; the Hopper sources share ``sm90_common.cuh``;
- ``bn_bwd`` — BatchNorm's backward reductions (K4a) and dx (K4b), wrapped
  by ``ops.batch_norm.bn_reduce`` and ``bn_dx``.
"""
