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
// What bounds it: bytes. Each pixel is read once as a float32 (4 B) and its
// score written once (4 B); the 16 ring reads and ~190 integer min/max per
// pixel are far below the card's integer rate. A (2, 2380, 752) atlas pair
// moves ~28.6 MB.
//
// What the design does about it: a 32x32-pixel block stages its tile plus a
// 3-px halo (38x38 int16 values, edge-replicated like jnp.pad(mode="edge"))
// in shared memory with coalesced row reads, so each input byte leaves device
// memory once (the halo re-read is 19% of a tile and is mostly L2 hits); the
// ring differences and arc chains then run from shared memory into
// registers. The TPU's 64-row VMEM tile, 8-row DMA halo and 128-lane column
// pad have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;        // threads per block along x
constexpr int kBY = 8;         // threads per block along y
constexpr int kRows = 4;       // output rows per thread
constexpr int kTW = kBX;       // tile width in pixels
constexpr int kTH = kBY * kRows;  // tile height in pixels
constexpr int kR = 3;          // ring radius = halo = zeroed border

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over the 16 circular 9-long arcs of the arc minimum, as the chain of
// pairwise minima 2 -> 4 -> 8 -> 9 over the ring wrapped to 24 entries. Every
// array index is a compile-time constant after unrolling, so the arrays live
// in registers. (A loop indexing the ring with (s + j) & 15 was miscompiled
// by nvcc 12.9 for sm_90/sm_90a: it read wrong ring entries at every
// optimisation level.)
__device__ __forceinline__ int arc_score(const int* d) {
  int dw[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) dw[i] = d[i & 15];
  int m2[23], m4[21], m8[17];
#pragma unroll
  for (int i = 0; i < 23; ++i) m2[i] = min(dw[i], dw[i + 1]);
#pragma unroll
  for (int i = 0; i < 21; ++i) m4[i] = min(m2[i], m2[i + 2]);
#pragma unroll
  for (int i = 0; i < 17; ++i) m8[i] = min(m4[i], m4[i + 4]);
  int r = min(m8[0], dw[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) r = max(r, min(m8[i], dw[i + 8]));
  return r;
}

__global__ void __launch_bounds__(kBX * kBY)
fast_score_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W) {
  __shared__ int16_t tile[kTH + 2 * kR][kTW + 2 * kR];
  const size_t plane = (size_t)H * (size_t)W;
  const float* img = in + (size_t)blockIdx.z * plane;
  float* dst = out + (size_t)blockIdx.z * plane;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;

  constexpr int kSW = kTW + 2 * kR;
  constexpr int kSN = (kTH + 2 * kR) * kSW;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kSN; i += kBX * kBY) {
    const int ty = i / kSW;
    const int tx = i - ty * kSW;
    const int gy = min(max(y0 + ty - kR, 0), H - 1);
    const int gx = min(max(x0 + tx - kR, 0), W - 1);
    tile[ty][tx] = (int16_t)__float2int_rn(img[(size_t)gy * W + gx]);
  }
  __syncthreads();

#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const int ly = threadIdx.y + r * kBY;
    const int lx = threadIdx.x;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W) continue;
    int best = 0;  // the clamp at >= 0 folded into the running max
    if (y >= kR && y < H - kR && x >= kR && x < W - kR) {
      const int c = tile[ly + kR][lx + kR];
      int d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = (int)tile[ly + kR + kDy[k]][lx + kR + kDx[k]] - c;
      }
      int nd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) nd[k] = -d[k];
      best = max(best, max(arc_score(d), arc_score(nd)));
    }
    dst[(size_t)y * W + x] = (float)best;
  }
}

}  // namespace

extern "C" int slam_fast_score(const void* in, void* out, int B, int H, int W,
                               void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, H, W);
  return (int)cudaGetLastError();
}
