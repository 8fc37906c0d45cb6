"""Hand-written Hopper kernels of the port, with their plain versions.

  wemd_swap.py           Triton: FSCD swap matrix, GS add row
                         (replace repro/kernels/wemd_swap.py)
  persample_gradnorm.py  CUDA C++ (csrc/): Eq. 10 sigma-hat for a
                         softmax-CE head (replaces
                         repro/kernels/persample_gradnorm.py)

ops.py dispatches on the tensor's device; ref.py holds the plain
versions; common.py the launch counts and the nvcc build.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
