// The squared distance every kernel of the port compares.
//
// Written as ((dx*dx + dy*dy) + dz*dz) with __fsub_rn/__fmul_rn/__fadd_rn,
// the order of the Pallas kernels (pallas_fps.py:117,
// pallas_ball_query.py:71, pallas_three_nn.py:48) and of the plain PyTorch
// versions. The intrinsics keep nvcc from contracting the sum into FMAs:
// a contracted sum rounds differently, which can flip a near-tie FPS
// argmax (and every later step with it) or move a point across a radius.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
