// Masked Hamming best-2 matcher over 256-bit descriptors, for sm_90a.
//
// The JAX package has no Pallas kernel here: ops/matching.py's hamming_matrix
// + masked_best2 + mutual_filter (and the second-best index of
// search_by_projection's ratio branch) run as XLA ops that materialise the
// (Q, T) distance matrix. Torch has no popcount, so the plain twin
// (ops/matching.py::best2_plain / col_argmin_plain) builds a (Q, T, 8) int32
// XOR tensor and a SWAR popcount over it.
//
// Semantics, exactly as the reference computes them with jnp.argmin:
//   d[q, t] = popcount(desc_q[q] ^ desc_t[t]) where mask[q, t], else BIG;
//   best_idx = the lowest t with the minimal d; best = d at best_idx;
//   second / second_idx = min / lowest argmin of d with ONLY position
//   best_idx replaced by BIG (so second == best on a tie), and
//   second_idx = 0 whenever that minimum is BIG (the replaced position ties);
//   col_idx[t] = the lowest q with the minimal d[:, t].
// Both rules fall out of ordering candidates by the 64-bit key
// (distance << 32 | index): the smallest key is the first argmin.
//
// What bounds it: bytes of the mask. Per query row the kernel reads T mask
// bytes and T x 32 B of train descriptors (L1/L2-resident: T <= 2048 rows are
// <= 64 KB); the 8 __popc per admissible pair are cheap. The (Q, T) distance
// matrix is never written.
//
// What the design does about it: one warp per query row walks the row with
// coalesced mask-byte reads and 2 x 16 B descriptor loads, keeps its lane's
// best and second key in registers and merges the 32 partial top-2 sets with
// warp shuffles. The column argmin (the cross-check of mutual_filter) is a
// second launch: one lane per train column, so that mask reads stay
// coalesced, and eight warps per block, each walking every eighth query row,
// whose partial keys merge in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kBig = 1u << 20;  // matching.BIG
constexpr unsigned long long kKeyMax = ~0ull;

__device__ __forceinline__ uint32_t hamming(const uint4& a0, const uint4& a1,
                                            const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ unsigned long long make_key(uint32_t d, uint32_t i) {
  return ((unsigned long long)d << 32) | (unsigned long long)i;
}

__global__ void best2_rows_kernel(const uint4* __restrict__ dq,
                                  const uint4* __restrict__ dt,
                                  const uint8_t* __restrict__ mask, int Q, int T,
                                  int* __restrict__ best_idx,
                                  int* __restrict__ best,
                                  int* __restrict__ second,
                                  int* __restrict__ second_idx) {
  const int q = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // warp-uniform: all lanes of a warp share q
  const uint4 qa = dq[2 * (size_t)q];
  const uint4 qb = dq[2 * (size_t)q + 1];
  const uint8_t* mrow = mask + (size_t)q * T;
  unsigned long long k1 = kKeyMax, k2 = kKeyMax;
  for (int t = lane; t < T; t += 32) {
    uint32_t d = kBig;
    if (mrow[t]) d = hamming(qa, qb, dt[2 * (size_t)t], dt[2 * (size_t)t + 1]);
    const unsigned long long k = make_key(d, (uint32_t)t);
    if (k < k1) {
      k2 = k1;
      k1 = k;
    } else if (k < k2) {
      k2 = k;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o1 = __shfl_down_sync(0xffffffffu, k1, off);
    const unsigned long long o2 = __shfl_down_sync(0xffffffffu, k2, off);
    if (k1 < o1) {
      k2 = min(k2, o1);
    } else {
      k2 = min(k1, o2);
      k1 = o1;
    }
  }
  if (lane == 0) {
    uint32_t s = (uint32_t)(k2 >> 32);
    uint32_t si = (uint32_t)(k2 & 0xffffffffu);
    if (s >= kBig) {  // no admissible second: jnp.argmin of all-BIG is 0
      s = kBig;
      si = 0;
    }
    best_idx[q] = (int)(k1 & 0xffffffffu);
    best[q] = (int)(k1 >> 32);
    second[q] = (int)s;
    second_idx[q] = (int)si;
  }
}

constexpr int kColW = 32;    // train columns per block (one per lane)
constexpr int kColRows = 8;  // warps per block, each a strided share of Q

__global__ void __launch_bounds__(kColW * kColRows)
argmin_cols_kernel(const uint4* __restrict__ dq, const uint4* __restrict__ dt,
                   const uint8_t* __restrict__ mask, int Q, int T,
                   int* __restrict__ col_idx) {
  __shared__ unsigned long long part[kColRows][kColW];
  const int t = blockIdx.x * kColW + threadIdx.x;
  unsigned long long k1 = kKeyMax;
  if (t < T) {
    const uint4 ta = dt[2 * (size_t)t];
    const uint4 tb = dt[2 * (size_t)t + 1];
    for (int q = threadIdx.y; q < Q; q += kColRows) {
      uint32_t d = kBig;
      if (mask[(size_t)q * T + t]) {
        d = hamming(dq[2 * (size_t)q], dq[2 * (size_t)q + 1], ta, tb);
      }
      k1 = min(k1, make_key(d, (uint32_t)q));
    }
  }
  part[threadIdx.y][threadIdx.x] = k1;
  __syncthreads();
  if (threadIdx.y == 0 && t < T) {
#pragma unroll
    for (int w = 1; w < kColRows; ++w) k1 = min(k1, part[w][threadIdx.x]);
    col_idx[t] = (int)(k1 & 0xffffffffu);
  }
}

}  // namespace

extern "C" int slam_hamming_best2(const void* desc_q, const void* desc_t,
                                  const void* mask, int Q, int T,
                                  void* best_idx, void* best, void* second,
                                  void* second_idx, void* stream) {
  const int threads = 256;  // 8 query rows per block
  const int blocks = (int)(((size_t)Q * 32 + threads - 1) / threads);
  best2_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)desc_q, (const uint4*)desc_t, (const uint8_t*)mask, Q, T,
      (int*)best_idx, (int*)best, (int*)second, (int*)second_idx);
  return (int)cudaGetLastError();
}

extern "C" int slam_hamming_argmin_cols(const void* desc_q, const void* desc_t,
                                        const void* mask, int Q, int T,
                                        void* col_idx, void* stream) {
  const dim3 block(kColW, kColRows);
  const int blocks = (T + kColW - 1) / kColW;
  argmin_cols_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const uint4*)desc_q, (const uint4*)desc_t, (const uint8_t*)mask, Q, T,
      (int*)col_idx);
  return (int)cudaGetLastError();
}
