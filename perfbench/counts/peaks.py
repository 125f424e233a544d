"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

# float32 outside the tensor cores (TF32 off), an FMA counted as two
FP32_FLOPS = 67e12
# float32 operations that are not FMAs: half the FMA rate (the point
# kernels' sq_dist.cuh forbids contraction)
FP32_OPS = FP32_FLOPS / 2
# HBM3
HBM_BYTES_PER_S = 3.35e12
