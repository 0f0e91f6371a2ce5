// Per-feature square patch extraction for Hopper (sm_90a).
//
// Replaces the TPU kernel uvipslam_tpu/ops/klt.py::_extract_patches_pallas
// (klt.py:230, pl.pallas_call at klt.py:288). That kernel kept the whole
// image in VMEM, cut eight features per program, snapped rows to 8 and
// rolled lanes into a [R, 128] window (R rows). Here the output is the slab
// contract of the reference's plain form (klt.py::_extract_patches):
// patches [N, psize, psize] and `local` [N, 2], the point's fractional
// position inside its patch. The corners and `local` are computed on the
// device with the reference's formula (patch_common.cuh), so one launch
// does the whole function and matches the plain torch gather
// (uvipslam_torch/ops/klt.py::_extract_patches) bit for bit, border,
// outside and non-finite points included.
//
// Launch: kFeats features per block of kWarps warps. The block's
// kFeats * psize patch rows are dealt to its warps; a warp copies one row
// with its lanes on consecutive pixels, so each row is one coalesced load
// and one coalesced store (a row wider than 32 takes the lanes again).
//
// Bound: memory. At N = 400, psize = 35 on a 512x640 image it must read
// at most the image once (1.31 MB) and write 1.96 MB of patches, ~1 us at
// 3.35 TB/s; nothing is computed beyond the corners. In practice the
// launch itself (a ctypes call) costs more than the copy, so the design
// removes the torch corner ops around it: one launch per call and no
// other device work. The anchor refinement, which pulls the most patches,
// does not come here at all: csrc/anchor_refine.cu pulls its patch into
// shared memory.

#include <cuda_runtime.h>

#include "patch_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kFeats = 4;

__global__ void __launch_bounds__(kWarps * 32)
extract_patches_kernel(const float* __restrict__ img, int H, int W,
                       const float* __restrict__ pts, int n, int psize,
                       float* __restrict__ out, float* __restrict__ local) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * kFeats;
  const int rows = kFeats * psize;
  for (int r = warp; r < rows; r += kWarps) {
    const int k = r / psize;
    const int f = f0 + k;
    if (f >= n) break;
    const int i = r - k * psize;
    const float px = pts[2 * f];
    const float py = pts[2 * f + 1];
    const int x0 = uvip::patch_corner(px, W, psize);
    const int y0 = uvip::patch_corner(py, H, psize);
    const float* src = img + static_cast<long long>(y0 + i) * W + x0;
    float* dst = out + (static_cast<long long>(f) * psize + i) * psize;
    for (int j = lane; j < psize; j += 32) dst[j] = src[j];
    if (i == 0 && lane < 2) {
      local[2 * f + lane] = lane == 0 ? px - static_cast<float>(x0)
                                      : py - static_cast<float>(y0);
    }
  }
}

}  // namespace

extern "C" int uvip_extract_patches(const float* img, int H, int W, const float* pts,
                                    int n, int psize, float* out, float* local,
                                    void* stream) {
  if (n <= 0) return 0;
  if (psize <= 0 || psize > H || psize > W) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kFeats - 1) / kFeats;
  extract_patches_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, pts, n, psize, out, local);
  return static_cast<int>(cudaGetLastError());
}
