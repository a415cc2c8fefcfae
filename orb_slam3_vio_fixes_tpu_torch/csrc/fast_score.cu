// Dense FAST-9/16 arc score over a batch of pyramid atlases, for sm_90a.
//
// Replaces the TPU kernel orb_slam3_vio_fixes_tpu/ops/pallas_kernels.py
// (fast_score_batch / _fast_score_kernel). Same contract as the plain version
// ops/fast.py::fast_score_plain, bit for bit: input (B, H, W) float32 with
// uint8-range intensities, rounded half-to-even to integers first; for each
// pixel the 16 Bresenham-ring differences to the centre; the min over every
// 9-long arc (circular wrap); the max over the 16 starts, for bright and for
// dark; clamped at >= 0; a 3-px border zeroed. Integer arithmetic in
// registers makes the score exact.
//
// What bounds it: instructions, not bytes. The pair moves 8 B per pixel
// (28.6 MB for a (2, 2380, 752) atlas pair, 8.5 us at 3.35 TB/s), but a
// scalar arc chain costs ~220 32-bit integer operations per pixel (two
// 92-op min/max chains, 32 differences), ~0.8 G ops per pair, which the
// card's INT32 lanes take ~50 us for.
//
// What the design does about it:
//   * bright and dark go through one chain: a pixel's value v and its
//     negation -v sit in the two 16-bit halves of one staged word,
//     S(v) = v | -v << 16;
//   * the centre c is the same for the whole ring, and min and max commute
//     with adding a constant, so the chain runs on the ring's words as they
//     are: min_k(v_k - c) = min_k(v_k) - c, and c - max_k(v_k) = min_k(-v_k)
//     + c. The clamp at >= 0 is a max with the centre's own word S(c), and
//     one 32-bit subtraction of S(c) at the end gives both scores (each half
//     is in [0, 255] then, so no borrow crosses the halves);
//   * the chain runs on Hopper's DPX three-input packed min/max
//     (__vimin3_s16x2 / __vimax3_s16x2, one instruction each):
//     m3[i] = min3(S[i..i+2]) (22 ops), m9[i] = min3(m3[i], m3[i+3],
//     m3[i+6]) (16), and a max3 tree over the 16 arcs and S(c) (8): 46
//     packed ops and one subtraction per pixel instead of 184 + 32;
//   * a 32x32-pixel block stages its tile plus an edge-clamped halo (rows
//     -3..+34, columns -4..+35, so that each staged row is ten aligned
//     16-B float4 loads when W % 4 == 0) as packed words in shared memory.
//
// Every array index is a compile-time constant after unrolling, so the
// arrays live in registers. (A loop indexing the ring with (s + j) & 15 was
// miscompiled by nvcc 12.9 for sm_90/sm_90a: it read wrong ring entries at
// every optimisation level.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;           // threads per block along x
constexpr int kBY = 8;            // threads per block along y
constexpr int kRows = 4;          // output rows per thread
constexpr int kTW = kBX;          // tile width in pixels
constexpr int kTH = kBY * kRows;  // tile height in pixels
constexpr int kR = 3;             // ring radius = zeroed border
constexpr int kPadX = 4;          // staged columns left and right of the tile
constexpr int kSW = kTW + 2 * kPadX;  // 40 staged columns
constexpr int kSH = kTH + 2 * kR;     // 38 staged rows

// S(v) = v | -v << 16; the scores stay exact while |v| <= 16383
__device__ __forceinline__ uint32_t packed_word(float x) {
  const int v = __float2int_rn(x);  // round half to even, as torch.round
  return ((uint32_t)v & 0xffffu) | ((uint32_t)-v << 16);
}

template <bool kVec>
__global__ void __launch_bounds__(kBX * kBY)
fast_score_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W) {
  __shared__ uint32_t tile[kSH][kSW];
  const size_t plane = (size_t)H * (size_t)W;
  const float* img = in + (size_t)blockIdx.z * plane;
  float* dst = out + (size_t)blockIdx.z * plane;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int tid = threadIdx.y * kBX + threadIdx.x;

  if (kVec) {  // W % 4 == 0: a float4 lies wholly inside or outside the row
    constexpr int kVW = kSW / 4;
    for (int i = tid; i < kSH * kVW; i += kBX * kBY) {
      const int ty = i / kVW;
      const int v = i - ty * kVW;
      const float* row = img + (size_t)min(max(y0 + ty - kR, 0), H - 1) * W;
      const int gx = x0 - kPadX + 4 * v;
      float4 f;
      if (gx >= 0 && gx < W) {
        f = *reinterpret_cast<const float4*>(row + gx);
      } else {
        const float e = row[gx < 0 ? 0 : W - 1];
        f = make_float4(e, e, e, e);
      }
      *reinterpret_cast<uint4*>(&tile[ty][4 * v]) =
          make_uint4(packed_word(f.x), packed_word(f.y), packed_word(f.z),
                     packed_word(f.w));
    }
  } else {
    for (int i = tid; i < kSH * kSW; i += kBX * kBY) {
      const int ty = i / kSW;
      const int tx = i - ty * kSW;
      const int gy = min(max(y0 + ty - kR, 0), H - 1);
      const int gx = min(max(x0 + tx - kPadX, 0), W - 1);
      tile[ty][tx] = packed_word(img[(size_t)gy * W + gx]);
    }
  }
  __syncthreads();

  // the Bresenham ring of radius 3, clockwise from the top
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const int ly = threadIdx.y + r * kBY;
    const int lx = threadIdx.x;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W) continue;
    int best = 0;
    if (y >= kR && y < H - kR && x >= kR && x < W - kR) {
      const int sy = ly + kR;
      const int sx = lx + kPadX;
      const uint32_t cw = tile[sy][sx];  // S(c)
      uint32_t dw[24];
#pragma unroll
      for (int k = 0; k < 16; ++k) dw[k] = tile[sy + kDy[k]][sx + kDx[k]];
#pragma unroll
      for (int k = 16; k < 24; ++k) dw[k] = dw[k - 16];
      uint32_t m3[22];
#pragma unroll
      for (int i = 0; i < 22; ++i) m3[i] = __vimin3_s16x2(dw[i], dw[i + 1], dw[i + 2]);
      uint32_t m9[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) m9[i] = __vimin3_s16x2(m3[i], m3[i + 3], m3[i + 6]);
      // max over the 16 arcs and S(c) (the clamp): 17 -> 1
      uint32_t a[6];
#pragma unroll
      for (int i = 0; i < 5; ++i) a[i] = __vimax3_s16x2(m9[3 * i], m9[3 * i + 1], m9[3 * i + 2]);
      a[5] = m9[15];
      const uint32_t b0 = __vimax3_s16x2(a[0], a[1], a[2]);
      const uint32_t b1 = __vimax3_s16x2(a[3], a[4], a[5]);
      const uint32_t s = __vimax3_s16x2(b0, b1, cw) - cw;  // bright | dark << 16
      best = (int)max(s & 0xffffu, s >> 16);
    }
    dst[(size_t)y * W + x] = (float)best;
  }
}

}  // namespace

extern "C" int slam_fast_score(const void* in, void* out, int B, int H, int W,
                               void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (W % 4 == 0 && (uintptr_t)in % 16 == 0) {
    fast_score_kernel<true><<<grid, block, 0, s>>>((const float*)in, (float*)out, H, W);
  } else {
    fast_score_kernel<false><<<grid, block, 0, s>>>((const float*)in, (float*)out, H, W);
  }
  return (int)cudaGetLastError();
}
