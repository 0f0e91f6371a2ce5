// Per-feature square patch extraction for Hopper (sm_90a).
//
// Replaces the TPU kernel uvipslam_tpu/ops/klt.py::_extract_patches_pallas
// (pl.pallas_call at klt.py:288). That kernel kept the whole image in VMEM,
// cut eight features per program, snapped rows to 8 and rolled lanes into a
// [R, 128] window (R rows). Here the output is the slab contract of the
// reference's plain form (klt.py::_extract_patches): patches
// [N, psize, psize] whose top-left corner is (x0[n], y0[n]). The wrapper
// (uvipslam_torch/ops/klt.py::extract_patches_any) computes the clipped
// int32 corners and the fractional `local` in torch with the reference's
// formula, so this kernel is a pure copy and matches the plain gather bit
// for bit.
//
// Launch: one block per feature; the block's threads stride over the
// psize*psize outputs in row-major order, so consecutive threads read
// consecutive pixels of an image row (coalesced) and write consecutive
// floats of the patch.
//
// Bound: memory. At N = 400, psize = 35 it writes 400*35*35*4 B = 1.96 MB
// and reads about as much (rows of neighbouring features overlap in L2);
// nothing is computed. Fusing the pull with _sample_patch and the
// Gauss-Newton loop of anchor_refine_fast in shared memory, so the patch
// never reaches device memory, is left for a later change.

#include <cuda_runtime.h>

namespace {

__global__ void extract_patches_kernel(const float* __restrict__ img, int W,
                                       const int* __restrict__ x0,
                                       const int* __restrict__ y0,
                                       int psize,
                                       float* __restrict__ out) {
  const int n = blockIdx.x;
  const int px = x0[n];
  const int py = y0[n];
  const int area = psize * psize;
  float* dst = out + static_cast<long long>(n) * area;
  for (int e = threadIdx.x; e < area; e += blockDim.x) {
    const int i = e / psize;
    const int j = e - i * psize;
    dst[e] = img[static_cast<long long>(py + i) * W + (px + j)];
  }
}

}  // namespace

extern "C" int uvip_extract_patches(const float* img, int H, int W,
                                    const int* x0, const int* y0, int n,
                                    int psize, float* out, void* stream) {
  (void)H;
  if (n <= 0) return 0;
  const int area = psize * psize;
  int threads = area < 256 ? ((area + 31) / 32) * 32 : 256;
  extract_patches_kernel<<<n, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      img, W, x0, y0, psize, out);
  return static_cast<int>(cudaGetLastError());
}
