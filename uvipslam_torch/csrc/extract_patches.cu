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
// A call serves S streams at once: img [S, H, W], pts [S, n, 2], out
// [S, n, psize, psize], local [S, n, 2], stream s on blockIdx.y. Each
// stream's corners are clipped to its own image, so a window near a border
// never reads the neighbouring stream's pixels.
//
// Launch: one block per feature, grid (n, S), so N = 400 is 400 blocks,
// three per SM. Every thread reads the point (one broadcast load) and
// computes the corner, thread 0 writes `local`; the feature's psize^2
// output elements are dealt to the block's threads in order, and each
// thread issues all its kPerThread image loads (unrolled into registers;
// every corner is clipped into the image, so every load is in bounds)
// before it stores any of them. Consecutive threads write consecutive
// output elements, so the stores are coalesced; the loads read psize-wide
// row segments. The element index is split into (row, column) by a
// multiplication with a reciprocal computed on the host, not a division.
//
// Bound: memory, and at the main path's sizes latency. At N = 400, psize
// 35 on a 512x640 image it must read at most the image once (1.31 MB) and
// write 1.96 MB of patches, ~1 us at 3.35 TB/s; nothing is computed
// beyond the corners. A launch is two dependent round trips to memory (the
// points, then the pixels) with up to kPerThread loads in flight per
// thread, against one load per warp and ~35 serial round trips per warp
// in the earlier design. TMA does not fit: a tensor map needs a row pitch
// that is a multiple of 16 B, and the ORB levels are 533, 444, 370, ...
// pixels wide; and a box whose inner extent is a multiple of 16 B, where a
// psize-35 row is 140 B and a psize-19 row 76 B. The anchor refinement,
// which pulls the most patches, does not come here at all:
// csrc/anchor_refine.cu pulls its patch into shared memory.

#include <cuda_runtime.h>

#include <algorithm>

#include "patch_common.cuh"

namespace {

constexpr int kPerThread = 8;     // image loads each thread has in flight
constexpr int kMaxThreads = 256;  // 2048 elements a pass; psize 127 takes eight

// floor(v / d) as (v * ceil(2^32 / d)) >> 32, exact while v * d < 2^32;
// here v < psize^2 and d = psize, so v * d < 127^3 < 2^21.
__device__ __forceinline__ unsigned div_by(unsigned v, unsigned long long magic) {
  return static_cast<unsigned>((v * magic) >> 32);
}

unsigned long long reciprocal(unsigned d) { return ((1ull << 32) + d - 1) / d; }

__global__ void __launch_bounds__(kMaxThreads)
extract_patches_kernel(const float* __restrict__ img, int H, int W,
                       const float* __restrict__ pts, int n, int psize,
                       unsigned long long m_row, float* __restrict__ out,
                       float* __restrict__ local) {
  const long long s = blockIdx.y;                    // stream
  const long long f = s * n + blockIdx.x;            // feature, over all streams
  const float px = pts[2 * f];
  const float py = pts[2 * f + 1];
  const int x0 = uvip::patch_corner(px, W, psize);
  const int y0 = uvip::patch_corner(py, H, psize);
  if (threadIdx.x == 0) {
    local[2 * f] = px - static_cast<float>(x0);
    local[2 * f + 1] = py - static_cast<float>(y0);
  }
  const unsigned area = psize * psize;
  const float* src = img + (s * H + y0) * W + x0;
  float* dst = out + f * area;
  for (unsigned base = threadIdx.x; base < area; base += blockDim.x * kPerThread) {
    float v[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      // past the end a thread reloads the last element, so no load waits
      // on a branch
      const unsigned e = min(base + u * blockDim.x, area - 1);
      const unsigned i = div_by(e, m_row);
      v[u] = src[static_cast<long long>(i) * W + (e - i * psize)];
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const unsigned e = base + u * blockDim.x;
      if (e < area) dst[e] = v[u];
    }
  }
}

}  // namespace

extern "C" int uvip_extract_patches(const float* img, int S, int H, int W,
                                    const float* pts, int n, int psize, float* out,
                                    float* local, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (psize <= 0 || psize > 127 || psize > H || psize > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = std::min(
      kMaxThreads, (psize * psize + 32 * kPerThread - 1) / (32 * kPerThread) * 32);
  extract_patches_kernel<<<dim3(n, S), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, pts, n, psize, reciprocal(psize), out, local);
  return static_cast<int>(cudaGetLastError());
}
