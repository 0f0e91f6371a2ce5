// Anchor-template refinement for Hopper (sm_90a): the patch pull fused
// with the whole Gauss-Newton loop of anchor_refine_fast.
//
// Replaces, on the tracking path, the TPU kernel
// uvipslam_tpu/ops/klt.py::_extract_patches_pallas (klt.py:230) as
// anchor_refine_fast (klt.py:311-366) called it, together with the
// interpolation matmuls and reductions that followed it there. It computes
// what anchor_refine_fast computes, per track:
//   psize = win + 2 * (int(max_correction) + 2), the patch at the
//   reference's clipped corner and `local` (patch_common.cuh);
//   the G terms of the template gradients, good_G = det > 1e-9, safe_det;
//   `iters` Gauss-Newton steps: a bilinear sample of the win x win window
//   at p - win//2, err, bx, by, the step clipped to +-3 and gated by
//   good_G, the per-axis clamp to [r, psize - r - 2] (r = win//2);
//   the mean absolute residual, the correction norm, the accept test, and
//   out = pts + (p - local) where accepted, else pts.
// The plain torch version is uvipslam_torch/ops/klt.py::_anchor_refine_plain.
//
// Arithmetic order follows the plain form: each sample is the row
// product first (Wy @ patch), then the column product (@ Wx^T), each an
// FMA chain over ascending k of the hat weights clamp(1 - |x - k|, 0, 1)
// at x = (p - r) + j; only the two taps with non-zero weight are visited.
// The library is built with -fmad=false, so every other product and sum
// rounds as its own torch op does. The 169-wide sums are warp butterflies
// (another order than torch.sum), so results agree with the plain version
// to float32 rounding, not bit for bit, and do not vary between runs.
//
// Edge behaviour copied from the plain form: the first sample is taken at
// p = local before any clamp, which can lie far outside the patch (a
// clipped corner, a point at -1e12); taps outside the patch carry no
// weight and are never read, since x is compared in float before any
// float->int conversion. A non-finite `local`, valid = false or good_G =
// false give accept = false and out = pts in the plain form whatever it
// computes, so those tracks skip the work.
//
// Launch: one warp per track, kTracks tracks per block. The warp pulls its
// psize^2 patch (<= 27^2 floats on the main path) into shared memory, its
// lanes on consecutive pixels of the patch's rows; each lane keeps its <= kPerLane
// template pixels (T, Tx, Ty) in registers. No atomics, so runs repeat bit
// for bit.
//
// Bound: memory. At N = 400, win 13 it must read 3 x 400 x 169 x 4 B =
// 0.81 MB of templates plus the image pixels under the patches (at most
// the image, 0.33 MB at 256x320 or 1.31 MB at 512x640) and write 4.8 KB,
// ~0.3-0.6 us at 3.35 TB/s; ~10 MFLOP of sampling is ~0.15 us at 67
// TFLOP/s float32. The design keeps the patch out of device memory and
// turns the ~900 small torch launches of the plain form into one.

#include <cuda_runtime.h>

#include "patch_common.cuh"

namespace {

constexpr int kTracks = 4;          // warps (tracks) per block
constexpr int kPerLane = 8;         // template pixels per lane: win * win <= 256
constexpr int kMaxPsize = 55;       // kTracks patches fit the 48 KB of shared memory

// torch.clamp's one-sided bounds: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// Butterfly sum: every lane ends with the same total (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The non-zero taps of one row of the interpolation operator at
// fractional position x over [0, P): k0 = floor(x) and k0 + 1.
struct Taps {
  int k0;
  float w0, w1;
  bool in0, in1;
};

__device__ __forceinline__ Taps hat_taps(float x, int P) {
  Taps t{0, 0.f, 0.f, false, false};
  if (x > -1.f && x < static_cast<float>(P)) {    // false for NaN and huge x
    const float f = floorf(x);
    t.k0 = static_cast<int>(f);
    t.w0 = fminf(fmaxf(1.f - fabsf(x - f), 0.f), 1.f);
    t.w1 = fminf(fmaxf(1.f - fabsf(x - (f + 1.f)), 0.f), 1.f);
    t.in0 = t.k0 >= 0;
    t.in1 = t.k0 + 1 < P;
  }
  return t;
}

// Column q of the row product Wy @ patch.
__device__ __forceinline__ float row_product(const float* patch, int P, const Taps& ty, int q) {
  float acc = 0.f;
  if (ty.in0) acc = fmaf(ty.w0, patch[ty.k0 * P + q], acc);
  if (ty.in1) acc = fmaf(ty.w1, patch[(ty.k0 + 1) * P + q], acc);
  return acc;
}

// One window pixel: the row product, then the column product.
__device__ __forceinline__ float sample(const float* patch, int P, float y, float x) {
  const Taps ty = hat_taps(y, P);
  const Taps tx = hat_taps(x, P);
  float acc = 0.f;
  if (tx.in0) acc = fmaf(row_product(patch, P, ty, tx.k0), tx.w0, acc);
  if (tx.in1) acc = fmaf(row_product(patch, P, ty, tx.k0 + 1), tx.w1, acc);
  return acc;
}

__global__ void __launch_bounds__(kTracks * 32)
anchor_refine_kernel(const float* __restrict__ img, int H, int W,
                     const float* __restrict__ T, const float* __restrict__ Tx,
                     const float* __restrict__ Ty, const float* __restrict__ pts,
                     const unsigned char* __restrict__ valid, int n, int win, int iters,
                     int psize, float max_correction, float max_residual,
                     float* __restrict__ out, unsigned char* __restrict__ accept) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kTracks + warp;
  if (t >= n) return;
  const float ptx = pts[2 * t];
  const float pty = pts[2 * t + 1];
  const int x0 = uvip::patch_corner(ptx, W, psize);
  const int y0 = uvip::patch_corner(pty, H, psize);
  const float lx = ptx - static_cast<float>(x0);
  const float ly = pty - static_cast<float>(y0);

  bool ok = valid[t] != 0 && isfinite(lx) && isfinite(ly);
  float px = lx, py = ly;
  if (ok) {
    const int area = win * win;
    const long long base = static_cast<long long>(t) * area;
    float tv[kPerLane], txv[kPerLane], tyv[kPerLane], fi[kPerLane], fj[kPerLane];
    float gxx = 0.f, gxy = 0.f, gyy = 0.f;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int e = lane + 32 * m;
      tv[m] = txv[m] = tyv[m] = 0.f;
      fi[m] = static_cast<float>(e / win);
      fj[m] = static_cast<float>(e % win);
      if (e < area) {
        tv[m] = T[base + e];
        txv[m] = Tx[base + e];
        tyv[m] = Ty[base + e];
        gxx += txv[m] * txv[m];
        gxy += txv[m] * tyv[m];
        gyy += tyv[m] * tyv[m];
      }
    }
    gxx = warp_sum(gxx);
    gxy = warp_sum(gxy);
    gyy = warp_sum(gyy);
    const float det = gxx * gyy - gxy * gxy;
    const float safe_det = fabsf(det) < 1e-12f ? 1.f : det;
    ok = det > 1e-9f;                              // good_G
    if (ok) {
      float* patch = smem + warp * psize * psize;
      for (int e = lane; e < psize * psize; e += 32) {
        const int i = e / psize;
        patch[e] = img[static_cast<long long>(y0 + i) * W + x0 + (e - i * psize)];
      }
      __syncwarp();

      const int r = win / 2;
      const float lo = static_cast<float>(r);
      const float hi = static_cast<float>(psize - r - 2);
      for (int it = 0; it < iters; ++it) {
        const float offx = px - static_cast<float>(r);
        const float offy = py - static_cast<float>(r);
        float bx = 0.f, by = 0.f;
#pragma unroll
        for (int m = 0; m < kPerLane; ++m) {
          if (lane + 32 * m < area) {
            const float err = sample(patch, psize, offy + fi[m], offx + fj[m]) - tv[m];
            bx += err * txv[m];
            by += err * tyv[m];
          }
        }
        bx = warp_sum(bx);
        by = warp_sum(by);
        const float dx = -(gyy * bx - gxy * by) / safe_det;
        const float dy = -(-gxy * bx + gxx * by) / safe_det;
        const float sx = clamp_max(clamp_min(dx, -3.f), 3.f);
        const float sy = clamp_max(clamp_min(dy, -3.f), 3.f);
        px = clamp_max(clamp_min(px + sx, lo), hi);
        py = clamp_max(clamp_min(py + sy, lo), hi);
      }
      const float offx = px - static_cast<float>(r);
      const float offy = py - static_cast<float>(r);
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        if (lane + 32 * m < area) {
          s += fabsf(sample(patch, psize, offy + fi[m], offx + fj[m]) - tv[m]);
        }
      }
      const float resid = warp_sum(s) / static_cast<float>(area);
      const float cx = px - lx;
      const float cy = py - ly;
      const float corr = sqrtf(cx * cx + cy * cy);
      ok = corr <= max_correction && resid < max_residual;
    }
  }
  if (lane == 0) {
    out[2 * t] = ok ? ptx + (px - lx) : ptx;
    out[2 * t + 1] = ok ? pty + (py - ly) : pty;
    accept[t] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int uvip_anchor_refine(const float* img, int H, int W, const float* T,
                                  const float* Tx, const float* Ty, const float* pts,
                                  const unsigned char* valid, int n, int win, int iters,
                                  float max_correction, float max_residual, float* out,
                                  unsigned char* accept, void* stream) {
  if (n <= 0) return 0;
  if (!(max_correction >= 0.f && max_correction < 1e6f) || win <= 0 ||
      win * win > 32 * kPerLane || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int psize = win + 2 * (static_cast<int>(max_correction) + 2);
  if (psize > H || psize > W || psize > kMaxPsize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + kTracks - 1) / kTracks;
  const size_t smem = static_cast<size_t>(kTracks) * psize * psize * sizeof(float);
  anchor_refine_kernel<<<blocks, kTracks * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, T, Tx, Ty, pts, valid, n, win, iters, psize, max_correction, max_residual,
      out, accept);
  return static_cast<int>(cudaGetLastError());
}
