"""Hand-written Hopper kernels of the port, with their plain versions.

  wemd_swap.py           CUDA C++ (csrc/wemd.cu): FSCD swap matrix, GS
                         add row, on f32 or f64 inputs (replace
                         repro/kernels/wemd_swap.py)
  persample_gradnorm.py  CUDA C++ (csrc/): Eq. 10 sigma-hat for a
                         softmax-CE head (replaces
                         repro/kernels/persample_gradnorm.py)
  flash_attention.py     CUDA C++: causal / sliding-window attention
                         (replaces repro/kernels/flash_attention.py), and
                         its backward (csrc/flash_attention_bwd.cu)
  rwkv_scan.py           CUDA C++: RWKV6 WKV recurrence (replaces
                         repro/kernels/rwkv_scan.py)
  rglru_scan.py          CUDA C++: RG-LRU diagonal recurrence (replaces
                         repro/kernels/rglru_scan.py), and its backward
  head_split.py          CUDA C++ (csrc/head_split.cu): the LM head's f32
                         product on the bf16 tensor cores, its f32
                         cotangent split into three bf16 terms (replaces
                         no TPU kernel)
  moe_rows.py            CUDA C++ (csrc/moe_rows.cu): the held-expert
                         MoE's dispatch and combine, forward and backward,
                         over the held assignments only (replaces no TPU
                         kernel)

ops.py dispatches on the tensor's device (and holds the autograd
Functions that pair a kernel with its backward); ref.py holds the plain
versions; common.py the launch counts and the nvcc build.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
