"""One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense
rates), at its full 700 W power limit."""
BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12      # TF32 on the tensor cores
F32_FLOPS = 67e12        # f32 outside the tensor cores
HBM_BW = 3.35e12         # bytes/s of HBM3
