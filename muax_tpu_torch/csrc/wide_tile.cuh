// What the tile kernels for towers wider than a block's shared memory share
// (fused_search_wide_kernel in fused_search.cu, fused_smz_wide_kernel in
// fused_smz.cu), for Hopper (sm_90a): the mbarrier and TMA bulk-copy
// primitives, the ring of weight pieces that streams a rank's share of the
// towers through shared memory, and the tile product of one phase.
//
// A tile of kT environments expands at once. Each block of its cluster
// computes its columns of every product for all kT rows: warp w owns whole
// output tiles of 8 columns over all rows; where a product has fewer column
// tiles than warps, the warps split its k-steps as well and add their
// partial sums in a fixed order. Every product is 3xTF32 as in tc_tile.cuh,
// so that the sums keep f32 accuracy. No float atomics; every sum runs in
// one order, so that a repeated launch gives the same bits.
#pragma once

#include <stdint.h>

#include "tc_tile.cuh"

namespace mz_wide {

constexpr int kWarps = 8;  // warps of a block of the tile kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Makes the barriers' initialisation visible to the cluster.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory, completing
// on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A ring of `ring` slots of `slot_floats` floats in shared memory that the
// streamed pieces of weights pass through, piece q in slot q mod ring:
// `full` completes when a slot's piece has landed, `empty` when every warp
// has released it.
struct Ring {
  float* slots;
  uint64_t* full;   // [ring]
  uint64_t* empty;  // [ring], kWarps arrivals
  int ring, slot_floats;

  // Thread 0: the copy of piece q (`bytes` from `src`) into its slot, once
  // every warp has released the slot's previous piece.
  __device__ void issue(long q, const float* src, uint32_t bytes) const {
    const int slot = static_cast<int>(q % ring);
    const long round = q / ring;
    if (round > 0)
      mbar_wait(empty + slot, static_cast<uint32_t>((round - 1) & 1));
    mbar_expect_tx(full + slot, bytes);
    bulk_copy(slots + static_cast<long>(slot) * slot_floats, src, bytes,
              full + slot);
  }

  // Piece q, once it has landed.
  __device__ __forceinline__ const float* wait(long q) const {
    const int slot = static_cast<int>(q % ring);
    mbar_wait(full + slot, static_cast<uint32_t>((q / ring) & 1));
    return slots + static_cast<long>(slot) * slot_floats;
  }

  // The warp is done with piece q.
  __device__ __forceinline__ void arrive(long q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + q % ring);
  }
};

// The warps that split the k-steps of a product of nt column tiles: the
// most, up to kWarps, that still leave each a whole column tile.
__host__ __device__ inline int k_split(int nt) {
  int S = 1;
  while (nt * S * 2 <= kWarps) S *= 2;
  return S;
}

// One product of a phase: acc = X [kT, in] W [in, nbs] for this block's nbs
// columns (a multiple of 8), W in `pieces` pieces of `prow` rows (the last
// ragged to in8, a multiple of 8; piece(pi) gives piece pi's rows in shared
// memory as [rows, nbs], done(pi) releases it; every warp takes every
// piece). X lies in shared memory with rows of ldx floats; columns at or
// past `in` read 0. Warp w takes the column tiles w / S + (kWarps / S) j,
// j < kNTW, and the k-steps congruent to w mod S counted over the whole
// product (so that the sums do not depend on where the pieces end), S the
// split that gives every warp work where there are fewer column tiles than
// warps; the S partial sums go through `red` (kWarps (kT / 16) 128 floats)
// and every warp of a split adds them up in the same order, so that they
// all hold the same sums. Leaves the warp's tiles' first and stride in *ng
// and *groups.
template <int kT, int kNTW, typename Piece, typename Done>
__device__ __forceinline__ void tile_product(
    const float* X, int ldx, int in, int nbs, int pieces, int in8, int prow,
    const Piece& piece, const Done& done, float* red,
    float (&acc)[kT / 16][kNTW][4], int* ng_out, int* groups_out) {
  constexpr int FM = kT / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int nt = nbs / 8;
  const int S = k_split(nt);
  const int groups = kWarps / S, ng = warp / S, ks0 = warp % S;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;

  for (int pi = 0; pi < pieces; ++pi) {
    const float* B = piece(pi);
    const int steps = min(prow, in8 - prow * pi) / 8;
    const int first = (ks0 - prow / 8 * pi) & (S - 1);
    for (int s = first; s < steps; s += S) {
      const int k = pi * prow + 8 * s;
      uint32_t ab[FM][4], as[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int row = 16 * i + gq + 8 * (h & 1);
          const int col = k + t + 4 * (h >> 1);
          mz_tc::split(col < in ? X[row * ldx + col] : 0.f, ab[i][h],
                       as[i][h]);
        }
      const float* brow = B + (8 * s + t) * nbs + gq;
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const int tile = ng + groups * j;
        if (tile >= nt) break;
        uint32_t bb0, bs0, bb1, bs1;
        mz_tc::split(brow[8 * tile], bb0, bs0);
        mz_tc::split(brow[8 * tile + 4 * nbs], bb1, bs1);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mz_tc::mma(part, as[i], bb0, bb1);
          mz_tc::mma(part, ab[i], bs0, bs1);
          mz_tc::mma(part, ab[i], bb0, bb1);
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[i][j][h] += part[h];
        }
      }
    }
    done(pi);
  }

  if (S > 1) {  // one column tile a warp: the S partial sums, in order
    float* mine = red + warp * FM * 128;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) mine[(i * 4 + h) * 32 + lane] = acc[i][0][h];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float v = 0.f;
        for (int u = 0; u < S; ++u)
          v += red[(warp - ks0 + u) * FM * 128 + (i * 4 + h) * 32 + lane];
        acc[i][0][h] = v;
      }
  }
  *ng_out = ng;
  *groups_out = groups;
}

// Calls f(m, n, sum) for each sum a warp holds after tile_product: row m of
// the tile, column n of the block's nbs = 8 nt.
template <int kT, int kNTW, typename F>
__device__ __forceinline__ void for_owned(const float (&acc)[kT / 16][kNTW][4],
                                          int ng, int groups, int nt,
                                          const F& f) {
  constexpr int FM = kT / 16;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNTW; ++j) {
    const int tile = ng + groups * j;
    if (tile >= nt) break;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        f(16 * i + gq + 8 * (h >> 1), 8 * tile + 2 * t + (h & 1),
          acc[i][j][h]);
  }
}

// The split of a product of nbs columns over the warps (tile_product's S),
// and the column tiles a warp owns at most: the host's check that an
// instance of kNTW tiles a warp can take the product.
__host__ __device__ inline int warp_tiles(int nbs) {
  const int nt = nbs / 8, S = k_split(nt);
  return (nt + kWarps / S - 1) / (kWarps / S);
}

}  // namespace mz_wide
