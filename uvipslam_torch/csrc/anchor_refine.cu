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
// at x = (p - r) + j; only the two taps k = floor(x), floor(x) + 1 are
// visited, the others having weight 0.
// The library is built with -fmad=false, so every other product and sum
// rounds as its own torch op does. The 169-wide sums run in the order of
// one warp per track: each lane adds its pixels L, L + 32, ... in
// ascending order, then a warp butterfly (another order than torch.sum),
// so results agree with the plain version to float32 rounding, not bit for
// bit, and do not vary between runs. Two warps per track keep that order
// exactly (each lane's sum goes on from warp 0's pixels to warp 1's), so
// both launch shapes give the same bits.
//
// Edge behaviour copied from the plain form: the first sample is taken at
// p = local before any clamp, which can lie far outside the patch (a
// clipped corner, a point at -1e12); a tap outside the patch gets weight
// 0 and reads a pixel inside it, which adds exactly nothing for a finite
// image, since x is compared in float before any float->int conversion.
// A non-finite `local`, valid = false or good_G = false give accept =
// false and out = pts in the plain form whatever it computes, so those
// tracks skip the work.
//
// A call serves S streams at once: img [S, H, W], T/Tx/Ty [S, n, win^2],
// pts [S, n, 2], valid [S, n], out [S, n, 2], accept [S, n], stream s on
// blockIdx.y, each stream's corners clipped to its own image.
//
// Launch: one block per track, grid (n, S), of two warps while a launch
// has at most kSplitTracks tracks (one stream: N = 400 is 800 warps, about
// six per SM, where the earlier design's four tracks per block gave 100
// blocks for 132 SMs), else of one warp (S = 8: 3200 blocks, all resident
// at once). Both give the same bits. The dynamic shared memory is the
// track's own psize^2 patch (2.5 KB at psize 25, 2.9 KB at 27), beside
// 1-5 KB of taps and sums. The block reads its point and starts the patch
// pull at once: psize^2 asynchronous 4-byte copies (cp.async, the warps
// on alternate rows, lanes on consecutive pixels), committed before the
// template loads and the G sums, which run while the copies are in
// flight; it waits for them only before the first sample. Every corner is
// clipped into the image, so the pull never reads outside it. Each thread
// keeps its kSlots template pixels (T, Tx, Ty) in registers. In each
// Gauss-Newton iteration lanes < win of each warp compute the
// interpolation taps of one window row and one window column into the
// warp's shared memory (double-buffered, one __syncwarp), and every pixel
// reads its row's and its column's taps there instead of computing both:
// the same float operations on the same values as the plain form's
// operator, done win times per axis instead of win^2. A sample has no
// branch (a zero-weight tap reads a clamped pixel) and the pixels per
// thread are a template argument, so a thread's pixels are independent
// chains the scheduler can overlap, where predicated reads made them one
// serial chain. With two warps a sum takes one __syncthreads (track_sum).
// No atomics, so runs repeat bit for bit.
//
// Bound: memory by the count below, latency in practice. At N = 400, win
// 13 it must read 3 x 400 x 169 x 4 B = 0.81 MB of templates plus the
// image pixels under the patches (at most the image, 0.33 MB at 256x320 or
// 1.31 MB at 512x640) and write 4.8 KB, ~0.3-0.6 us at 3.35 TB/s; ~10
// MFLOP of sampling is ~0.15 us at 67 TFLOP/s float32. What a launch
// really waits for is each track's chain: two round trips to memory (the
// point, then the patch and templates together), then `iters` iterations
// of taps, samples from shared memory, two 5-step butterflies, a barrier
// and a division; two warps per track halve each warp's samples. Once the
// card is full the second warp's duplicated taps, butterflies and step
// cost more than that saves, hence kSplitTracks. The design keeps the
// patch out of device memory and turns the ~900 small torch launches of
// the plain form into one. TMA does not fit the pull: a tensor map needs a
// row pitch that is a multiple of 16 B, which a caller's image need not
// have, and a box whose inner extent is a multiple of 16 B, where a
// psize-25 row is 100 B and a psize-27 row 108 B.

#include <cuda_runtime.h>

#include "patch_common.cuh"

namespace {

constexpr int kMaxSlots = 8;        // template pixels per lane of one warp: win * win <= 256
constexpr int kMaxWin = 16;         // so win <= 16
constexpr int kMaxPsize = 55;       // the patch in shared memory: 12.1 KB at most
// Tracks per launch up to which each track gets two warps: about two
// tracks per SM on an H100 (132 SMs). On it two warps were faster for one
// stream (400 tracks) and slower for eight (3200), at psize 25 and 27.
constexpr long long kSplitTracks = 1024;

// torch.clamp's one-sided bounds: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// Butterfly sum: every lane ends with the same total (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// kN sums over the track's pixels, each in the order of one warp per
// track: lane L adds its pixels L, L + 32, L + 64, ... in ascending order,
// then a butterfly over the lanes. With two warps, warp 0 stores its
// per-lane partial sums and warp 1 its terms into `buf`, and after one
// barrier both warps finish every lane's sum in that order and do the same
// butterfly, so all threads hold the same totals. `buf` is one of two
// buffers taken in turn, so a sum never overwrites what a thread may still
// read of the previous one.
template <int kWarps, int kN, int kSlots>
__device__ __forceinline__ void track_sum(float (&v)[kN], const float (&terms)[kN][kSlots],
                                          float (*buf)[32], int warp, int lane) {
  float a[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = 0.f;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) a[k] += terms[k][m];
  }
  if constexpr (kWarps == 2) {
    // buf rows: kN partials of warp 0, then warp 1's kN x kSlots terms
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (warp == 0) {
        buf[k][lane] = a[k];
      } else {
#pragma unroll
        for (int m = 0; m < kSlots; ++m) buf[kN + k * kSlots + m][lane] = terms[k][m];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      a[k] = buf[k][lane];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) a[k] += buf[kN + k * kSlots + m][lane];
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) v[k] = warp_sum(a[k]);
}

// The two taps of one row of the interpolation operator at fractional
// position x over [0, P): k0 = floor(x) and k0 + 1, as offsets (times
// `stride`) clamped into the patch, with their hat weights; a tap outside
// the patch (and both where x lies outside (-1, P), NaN included) gets
// weight 0.
struct __align__(16) Taps {
  int o0, o1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float x, int P, int stride) {
  const bool in = x > -1.f && x < static_cast<float>(P);   // false for NaN and huge x
  const float f = in ? floorf(x) : 0.f;
  const int k0 = static_cast<int>(f);
  Taps t;
  t.w0 = in && k0 >= 0 ? fminf(fmaxf(1.f - fabsf(x - f), 0.f), 1.f) : 0.f;
  t.w1 = in && k0 + 1 < P ? fminf(fmaxf(1.f - fabsf(x - (f + 1.f)), 0.f), 1.f) : 0.f;
  t.o0 = max(k0, 0) * stride;
  t.o1 = min(k0 + 1, P - 1) * stride;
  return t;
}

// One window pixel: the row product (Wy @ patch) at the two columns, then
// the column product, each an FMA chain over ascending k from +0. A
// zero-weight tap reads a pixel inside the patch and adds exactly nothing
// (fma(0, v, a) == a for finite v, and no partial sum here is -0), so the
// result is the plain form's sum over the non-zero taps, without a branch.
__device__ __forceinline__ float sample(const float* patch, const Taps& ty, const Taps& tx) {
  const float* row0 = patch + ty.o0;
  const float* row1 = patch + ty.o1;
  const float c0 = fmaf(ty.w1, row1[tx.o0], fmaf(ty.w0, row0[tx.o0], 0.f));
  const float c1 = fmaf(ty.w1, row1[tx.o1], fmaf(ty.w0, row0[tx.o1], 0.f));
  return fmaf(c1, tx.w1, fmaf(c0, tx.w0, 0.f));
}

// The taps of window row `lane` (at y = offy + lane) and window column
// `lane` (at x = offx + lane), for lanes < win, into the warp's own copy,
// then a __syncwarp.
__device__ __forceinline__ void set_taps(Taps (*taps)[kMaxWin], int lane, int win, int P,
                                         float offy, float offx) {
  if (lane < win) {
    taps[0][lane] = hat_taps(offy + static_cast<float>(lane), P, P);
    taps[1][lane] = hat_taps(offx + static_cast<float>(lane), P, 1);
  }
  __syncwarp();
}

__device__ __forceinline__ void copy_async_4(unsigned dst_shared, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_shared), "l"(src)
               : "memory");
}

// kWarps warps per track, kSlots = ceil(ceil(win^2 / 32) / kWarps) pixels
// per thread: template arguments, so that a thread's samples are
// straight-line code the scheduler can interleave.
template <int kWarps, int kSlots>
__global__ void __launch_bounds__(32 * kWarps)
anchor_refine_kernel(const float* __restrict__ img, int H, int W,
                     const float* __restrict__ T, const float* __restrict__ Tx,
                     const float* __restrict__ Ty, const float* __restrict__ pts,
                     const unsigned char* __restrict__ valid, int n, int win, int iters,
                     int psize, float max_correction, float max_residual,
                     float* __restrict__ out, unsigned char* __restrict__ accept) {
  extern __shared__ float patch[];                  // psize * psize
  __shared__ Taps taps[kWarps][2][2][kMaxWin];      // [warp][buffer][rows, columns][index]
  // track_sum's two buffers (two warps): 3 partials and 3 x kSlots terms per lane
  __shared__ float sums[2][kWarps == 2 ? 3 + 3 * kSlots : 1][32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = blockIdx.x;                         // track
  const long long s = blockIdx.y;                   // stream
  const long long sn = s * n;
  img += s * H * W;
  T += sn * win * win;
  Tx += sn * win * win;
  Ty += sn * win * win;
  pts += sn * 2;
  valid += sn;
  out += sn * 2;
  accept += sn;
  const float ptx = pts[2 * t];
  const float pty = pts[2 * t + 1];
  const int x0 = uvip::patch_corner(ptx, W, psize);
  const int y0 = uvip::patch_corner(pty, H, psize);
  const float lx = ptx - static_cast<float>(x0);
  const float ly = pty - static_cast<float>(y0);

  bool ok = valid[t] != 0 && isfinite(lx) && isfinite(ly);    // the same in every thread
  float px = lx, py = ly;
  if (ok) {
    // the pull first: every copy in flight before the templates are read
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(patch));
    const float* src = img + static_cast<long long>(y0) * W + x0;
    for (int i = warp; i < psize; i += kWarps) {
      for (int j = lane; j < psize; j += 32) {
        copy_async_4(dst + 4u * (i * psize + j), src + static_cast<long long>(i) * W + j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int area = win * win;
    const long long base = static_cast<long long>(t) * area;
    // lane L of warp w holds pixels L + 32 (w kSlots + m); one past the
    // window holds the window's last pixel with zero templates: it adds
    // exactly +0 to every sum (none of which is -0), and its loads wait on
    // no branch
    float tv[kSlots], txv[kSlots], tyv[kSlots];
    int ti[kSlots], tj[kSlots];                       // the pixel's window row and column
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int e = lane + 32 * (warp * kSlots + m);
      const int ec = min(e, area - 1);
      ti[m] = ec / win;
      tj[m] = ec % win;
      tv[m] = e < area ? T[base + ec] : 0.f;
      txv[m] = e < area ? Tx[base + ec] : 0.f;
      tyv[m] = e < area ? Ty[base + ec] : 0.f;
    }
    float gt[3][kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      gt[0][m] = txv[m] * txv[m];
      gt[1][m] = txv[m] * tyv[m];
      gt[2][m] = tyv[m] * tyv[m];
    }
    float g[3];                                     // gxx, gxy, gyy
    int phase = 0;                                  // track_sum's buffer
    track_sum<kWarps>(g, gt, sums[phase++ & 1], warp, lane);
    const float gxx = g[0], gxy = g[1], gyy = g[2];
    const float det = gxx * gyy - gxy * gxy;
    const float safe_det = fabsf(det) < 1e-12f ? 1.f : det;
    ok = det > 1e-9f;                              // good_G
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                               // every thread's copies visible to all
    if (ok) {
      const int r = win / 2;
      const float lo = static_cast<float>(r);
      const float hi = static_cast<float>(psize - r - 2);
      for (int it = 0; it < iters; ++it) {
        Taps(*tp)[kMaxWin] = taps[warp][it & 1];
        set_taps(tp, lane, win, psize, py - static_cast<float>(r), px - static_cast<float>(r));
        float bt[2][kSlots];
#pragma unroll
        for (int m = 0; m < kSlots; ++m) {
          const float err = sample(patch, tp[0][ti[m]], tp[1][tj[m]]) - tv[m];
          bt[0][m] = err * txv[m];
          bt[1][m] = err * tyv[m];
        }
        float b[2];                                 // bx, by
        track_sum<kWarps>(b, bt, sums[phase++ & 1], warp, lane);
        const float dx = -(gyy * b[0] - gxy * b[1]) / safe_det;
        const float dy = -(-gxy * b[0] + gxx * b[1]) / safe_det;
        const float sx = clamp_max(clamp_min(dx, -3.f), 3.f);
        const float sy = clamp_max(clamp_min(dy, -3.f), 3.f);
        px = clamp_max(clamp_min(px + sx, lo), hi);
        py = clamp_max(clamp_min(py + sy, lo), hi);
      }
      Taps(*tp)[kMaxWin] = taps[warp][iters & 1];
      set_taps(tp, lane, win, psize, py - static_cast<float>(r), px - static_cast<float>(r));
      float at[1][kSlots];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float a = fabsf(sample(patch, tp[0][ti[m]], tp[1][tj[m]]) - tv[m]);
        at[0][m] = lane + 32 * (warp * kSlots + m) < area ? a : 0.f;
      }
      float asum[1];
      track_sum<kWarps>(asum, at, sums[phase & 1], warp, lane);
      const float resid = asum[0] / static_cast<float>(area);
      const float cx = px - lx;
      const float cy = py - ly;
      const float corr = sqrtf(cx * cx + cy * cy);
      ok = corr <= max_correction && resid < max_residual;
    }
  }
  if (tid == 0) {
    out[2 * t] = ok ? ptx + (px - lx) : ptx;
    out[2 * t + 1] = ok ? pty + (py - ly) : pty;
    accept[t] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int uvip_anchor_refine(const float* img, int S, int H, int W, const float* T,
                                  const float* Tx, const float* Ty, const float* pts,
                                  const unsigned char* valid, int n, int win, int iters,
                                  float max_correction, float max_residual, float* out,
                                  unsigned char* accept, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!(max_correction >= 0.f && max_correction < 1e6f) || win <= 0 || win > kMaxWin ||
      win * win > 32 * kMaxSlots || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int psize = win + 2 * (static_cast<int>(max_correction) + 2);
  if (psize > H || psize > W || psize > kMaxPsize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Kernel = decltype(&anchor_refine_kernel<1, 1>);
  const Kernel one_warp[kMaxSlots] = {
      anchor_refine_kernel<1, 1>, anchor_refine_kernel<1, 2>, anchor_refine_kernel<1, 3>,
      anchor_refine_kernel<1, 4>, anchor_refine_kernel<1, 5>, anchor_refine_kernel<1, 6>,
      anchor_refine_kernel<1, 7>, anchor_refine_kernel<1, 8>};
  const Kernel two_warps[kMaxSlots / 2] = {anchor_refine_kernel<2, 1>, anchor_refine_kernel<2, 2>,
                                           anchor_refine_kernel<2, 3>, anchor_refine_kernel<2, 4>};
  const int slots = (win * win + 31) / 32;
  // both give the same bits; two warps while the card has room for them
  const bool split = static_cast<long long>(S) * n <= kSplitTracks;
  const Kernel kernel = split ? two_warps[(slots + 1) / 2 - 1] : one_warp[slots - 1];
  const size_t smem = static_cast<size_t>(psize) * psize * sizeof(float);
  kernel<<<dim3(n, S), split ? 64 : 32, smem, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, T, Tx, Ty, pts, valid, n, win, iters, psize, max_correction, max_residual,
      out, accept);
  return static_cast<int>(cudaGetLastError());
}
