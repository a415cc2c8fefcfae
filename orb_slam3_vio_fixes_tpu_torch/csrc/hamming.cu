// Masked Hamming best-2 per query row and argmin per train column over
// 256-bit descriptors, in one launch, for sm_90a.
//
// The JAX package has no Pallas kernel here: ops/matching.py's hamming_matrix
// + masked_best2 + mutual_filter (and the second-best index of
// search_by_projection's ratio branch) run as XLA ops that materialise the
// (Q, T) distance matrix. Torch has no popcount, so the plain twin
// (ops/matching.py::match_plain) builds a (Q, T, 8) int32 XOR tensor and a
// SWAR popcount over it.
//
// Semantics, exactly as the reference computes them with jnp.argmin:
//   d[q, t] = popcount(desc_q[q] ^ desc_t[t]) where mask[q, t], else BIG;
//   best_idx = the lowest t with the minimal d; best = d at best_idx;
//   second / second_idx = min / lowest argmin of d with ONLY position
//   best_idx replaced by BIG (so second == best on a tie), and
//   second_idx = 0 whenever that minimum is BIG (the replaced position ties);
//   col_idx[t] = the lowest q with the minimal d[:, t].
// Both rules fall out of ordering candidates by the key (distance, index):
// the smallest key is the first argmin, and keys are unique, so partial
// top-2 sets and partial column minima merge in any order.
//
// What bounds it: at the path's shapes (Q, T <= 2048) neither bytes nor
// operations: the (Q, T) mask is 1-4 MB (0.3-1.3 us at 3.35 TB/s) and the
// 8 XOR + 8 POPC per admissible pair are fewer still, so launch latency and
// the spread of the work over 132 SMs set the time.
//
// What the design does about it:
//   * one launch computes rows and columns, so the mask is read and each
//     distance computed once (the column pass is optional: want_cols);
//   * the (Q, T) plane is cut into 32-query x 256-train tiles, a block of
//     8 warps each; a cluster of kCluster blocks (Hopper thread block
//     cluster) takes one 32-query row strip, block r walking the train tiles
//     r, r + kCluster, ...: 128 blocks at 1024 x 1024, 256 at 2048 x 1024;
//   * a tile's train descriptors (8 KB) and mask (32 x 256 B, 16-B vectors
//     where T allows) are staged in shared memory with cp.async; each lane
//     owns one query, holds its descriptor in registers and walks 32 trains
//     of its warp's share with broadcast shared-memory reads;
//   * rows: each lane keeps a 32-bit top-2 of tile-local keys
//     (d << 8 | t_local), widened to (d << 32 | t) per tile; the 8 warps
//     merge in shared memory and the cluster's blocks through distributed
//     shared memory, so no partials go to device memory;
//   * columns: each lane holds 32 column keys (d << 5 | lane); a butterfly of
//     31 shuffles leaves lane j with the tile's minimum of column j; one
//     64-bit atomicMin per column and tile merges the strips into col_key,
//     which the entry point fills with ~0 first. A tile whose column has no
//     admissible pair skips its atomic, except in the first strip, which so
//     writes (BIG << 32 | 0) for an all-masked column: col_idx = 0, as
//     jnp.argmin of an all-BIG column.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kBig = 1u << 20;  // matching.BIG
constexpr unsigned long long kKeyMax = ~0ull;
constexpr int kTQ = 32;                // queries per block, one per lane
constexpr int kWarps = 8;              // each takes 32 trains of the tile
constexpr int kTT = 32 * kWarps;       // trains per tile (t_local < 256: 8 bits)
constexpr int kCluster = 4;            // blocks per row strip
// A mask row of the tile padded to 272 B: the 8 lanes of a quarter warp
// reading 16 B from 8 consecutive rows hit 8 disjoint 4-bank groups.
constexpr int kMaskStride = kTT + 16;

__device__ __forceinline__ uint32_t hamming(const uint4& a0, const uint4& a1,
                                            const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Merge the top-2 set (b1 < b2) into (a1 < a2). Keys are unique (or the
// ~0 sentinel), so the result does not depend on the order of merges.
__device__ __forceinline__ void merge2(unsigned long long& a1,
                                       unsigned long long& a2,
                                       unsigned long long b1,
                                       unsigned long long b2) {
  if (b1 < a1) {
    a2 = min(a1, b2);
    a1 = b1;
  } else {
    a2 = min(a2, b1);
  }
}

// Tile-local row key (d << 8 | t_local) -> global key (d << 32 | t); order
// within a tile is kept, the sentinel stays the sentinel.
__device__ __forceinline__ unsigned long long widen_key(uint32_t rk, int t0) {
  return rk == ~0u ? kKeyMax
                   : ((unsigned long long)(rk >> 8) << 32) | (uint32_t)(t0 + (int)(rk & 255u));
}

// One butterfly step over a warp's column keys: a lane keeps the half of
// its 2S columns selected by its lane bit S and takes the partner's keys for
// that half. One template per step, so that every index of ck is a constant
// and ck stays in registers.
template <int S>
__device__ __forceinline__ void fold_columns(uint32_t (&ck)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const uint32_t keep = upper ? ck[i + S] : ck[i];
    const uint32_t send = upper ? ck[i] : ck[i + S];
    ck[i] = min(keep, __shfl_xor_sync(0xffffffffu, send, S));
  }
}

template <bool kCols, bool kVecMask>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWarps * 32)
match_kernel(const uint4* __restrict__ dq, const uint4* __restrict__ dt,
             const uint8_t* __restrict__ mask, int Q, int T,
             int* __restrict__ best_idx, int* __restrict__ best,
             int* __restrict__ second, int* __restrict__ second_idx,
             unsigned long long* __restrict__ col_key) {
  __shared__ __align__(16) uint8_t msk[kTQ][kMaskStride];
  __shared__ uint4 tdesc[kTT][2];
  __shared__ unsigned long long part1[kWarps][kTQ];
  __shared__ unsigned long long part2[kWarps][kTQ];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const int nq = min(kTQ, Q - q0);
  const int q = q0 + lane;
  uint4 qa = make_uint4(0u, 0u, 0u, 0u), qb = qa;
  if (lane < nq) {
    qa = dq[2 * (size_t)q];
    qb = dq[2 * (size_t)q + 1];
  }
  unsigned long long k1 = kKeyMax, k2 = kKeyMax;

  for (int t0 = (int)rank * kTT; t0 < T; t0 += kCluster * kTT) {
    const int nt = min(kTT, T - t0);
    for (int i = threadIdx.x; i < 2 * nt; i += kWarps * 32) {
      cp_async16(&tdesc[0][0] + i, dt + 2 * (size_t)t0 + i);
    }
    if (kVecMask) {  // T % 16 == 0, so nt is too
      for (int i = threadIdx.x; i < kTQ * (kTT / 16); i += kWarps * 32) {
        const int r = i / (kTT / 16);
        const int c = (i % (kTT / 16)) * 16;
        if (r < nq && c < nt) {
          cp_async16(&msk[r][c], mask + (size_t)(q0 + r) * T + t0 + c);
        } else {
          *reinterpret_cast<uint4*>(&msk[r][c]) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTQ * kTT; i += kWarps * 32) {
        const int r = i / kTT;
        const int c = i % kTT;
        msk[r][c] = (r < nq && c < nt) ? mask[(size_t)(q0 + r) * T + t0 + c] : 0;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    uint32_t r1 = ~0u, r2 = ~0u;  // tile-local row top-2 keys (d << 8 | t_local)
    uint32_t ck[32];              // column keys (d << 5 | lane) of this warp's trains
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 mv = *reinterpret_cast<const uint4*>(&msk[lane][warp * 32 + h * 16]);
      const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = h * 16 + jj;
        const int tl = warp * 32 + j;
        uint32_t d = kBig;
        if ((mw[jj >> 2] >> (8 * (jj & 3))) & 0xffu) {
          d = hamming(qa, qb, tdesc[tl][0], tdesc[tl][1]);
        }
        const bool in = tl < nt;
        const uint32_t rk = in ? (d << 8) | (uint32_t)tl : ~0u;
        r2 = min(r2, max(r1, rk));
        r1 = min(r1, rk);
        if (kCols) ck[j] = (in && lane < nq) ? (d << 5) | (uint32_t)lane : ~0u;
      }
    }
    merge2(k1, k2, widen_key(r1, t0), widen_key(r2, t0));

    if (kCols) {
      // after the five butterfly steps ck[0] of lane j is the minimum over
      // all 32 lanes of column j
      fold_columns<16>(ck, lane);
      fold_columns<8>(ck, lane);
      fold_columns<4>(ck, lane);
      fold_columns<2>(ck, lane);
      fold_columns<1>(ck, lane);
      const int tl = warp * 32 + lane;
      if (tl < nt) {
        const uint32_t d = ck[0] >> 5;
        if (d < kBig || q0 == 0) {
          atomicMin(col_key + t0 + tl,
                    ((unsigned long long)d << 32) | (uint32_t)(q0 + (ck[0] & 31u)));
        }
      }
    }
    __syncthreads();  // the next tile overwrites the staging buffers
  }

  part1[warp][lane] = k1;
  part2[warp][lane] = k2;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge2(k1, k2, part1[w][lane], part2[w][lane]);
    part1[0][lane] = k1;
    part2[0][lane] = k2;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      const unsigned long long* p1 = cluster.map_shared_rank(&part1[0][0], r);
      const unsigned long long* p2 = cluster.map_shared_rank(&part2[0][0], r);
      merge2(k1, k2, p1[lane], p2[lane]);
    }
    if (lane < nq) {
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
  cluster.sync();  // keep every block's shared memory alive until rank 0 read it
}

template <bool kCols, bool kVecMask>
void launch(const void* desc_q, const void* desc_t, const void* mask, int Q,
            int T, void* best_idx, void* best, void* second, void* second_idx,
            void* col_key, cudaStream_t stream) {
  const dim3 grid(kCluster, (Q + kTQ - 1) / kTQ);
  match_kernel<kCols, kVecMask><<<grid, kWarps * 32, 0, stream>>>(
      (const uint4*)desc_q, (const uint4*)desc_t, (const uint8_t*)mask, Q, T,
      (int*)best_idx, (int*)best, (int*)second, (int*)second_idx,
      (unsigned long long*)col_key);
}

}  // namespace

// best_idx, best, second, second_idx: (Q,) int32. col_key: (T,) uint64 when
// want_cols, its low 32 bits the column's argmin; unused (may be null)
// otherwise.
extern "C" int slam_hamming_match(const void* desc_q, const void* desc_t,
                                  const void* mask, int Q, int T, int want_cols,
                                  void* best_idx, void* best, void* second,
                                  void* second_idx, void* col_key, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = T % 16 == 0 && (uintptr_t)mask % 16 == 0;
  if (want_cols) {
    const cudaError_t e = cudaMemsetAsync(col_key, 0xff, (size_t)T * 8, s);
    if (e != cudaSuccess) return (int)e;
    if (vec) {
      launch<true, true>(desc_q, desc_t, mask, Q, T, best_idx, best, second,
                         second_idx, col_key, s);
    } else {
      launch<true, false>(desc_q, desc_t, mask, Q, T, best_idx, best, second,
                          second_idx, col_key, s);
    }
  } else if (vec) {
    launch<false, true>(desc_q, desc_t, mask, Q, T, best_idx, best, second,
                        second_idx, col_key, s);
  } else {
    launch<false, false>(desc_q, desc_t, mask, Q, T, best_idx, best, second,
                         second_idx, col_key, s);
  }
  return (int)cudaGetLastError();
}
