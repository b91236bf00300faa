"""The program's kernel and op names the kernel readers look for."""

#: K1, ``tpu_bfs_torch/csrc/ell_expand.cu``, behind ``tpu_bfs_torch::ell_expand``.
K1_KERNEL = "ell_expand_kernel"
K1_OP = "tpu_bfs_torch::ell_expand"
#: K2, ``tpu_bfs_torch/csrc/tile_spmm.cu``, behind ``tpu_bfs_torch::tile_spmm``.
K2_KERNEL = "tile_spmm_kernel"
K2_OP = "tpu_bfs_torch::tile_spmm"
