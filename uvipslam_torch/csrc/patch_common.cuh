// The reference's patch-corner formula, shared by the patch kernels.
//
// uvipslam_tpu/ops/klt.py::_extract_patches places a feature's [psize,
// psize] patch at clip(int32(floor(pt)) - psize//2, 0, dim - psize) and
// reports `local = pt - corner`. The plain torch form of the port is
// uvipslam_torch/ops/klt.py::patch_corners; this header computes the same
// values bit for bit on the device:
//   - floor(pt) cast to int32 with XLA's saturating conversion (NaN -> 0,
//     overflow -> INT32_MAX / INT32_MIN), decided in float before any
//     conversion, so nothing overflows;
//   - `- psize//2` with int32 wraparound, done in unsigned arithmetic
//     (signed overflow is undefined in C++);
//   - the clip to [0, dim - psize];
//   - `local = pt - corner` in float32.

#pragma once

#include <climits>

namespace uvip {

__device__ __forceinline__ int floor_to_int32_saturating(float v) {
  const float f = floorf(v);
  if (f != f) return 0;                           // NaN
  if (f >= 2147483648.0f) return INT_MAX;         // +inf and overflow
  if (f < -2147483648.0f) return INT_MIN;         // -inf and underflow
  return static_cast<int>(f);
}

// Top-left corner of a feature's patch along one axis of length `dim`.
__device__ __forceinline__ int patch_corner(float pt, int dim, int psize) {
  const unsigned wrapped = static_cast<unsigned>(floor_to_int32_saturating(pt)) -
                           static_cast<unsigned>(psize / 2);
  int c = static_cast<int>(wrapped);
  c = c < 0 ? 0 : c;
  const int hi = dim - psize;
  return c > hi ? hi : c;
}

}  // namespace uvip
