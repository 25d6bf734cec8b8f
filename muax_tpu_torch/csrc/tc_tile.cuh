// The tensor-core tile product of the categorical family's kernels (the
// search kernel's categorical modes in fused_search.cu and the categorical
// learner's two kernels in fused_learner.cu), for Hopper (sm_90a).
//
// A warp computes a (16 FM) x (8 FN) tile of C = A B with mma.sync
// m16n8k8 on TF32 operands and f32 sums. One TF32 pass keeps about three
// decimal digits, too few for the learner's rtol 5e-4, so every product is
// error-compensated 3xTF32: each operand splits as x = big + small with
// big = tf32(x) and small = tf32(x - big), and the sum takes
// small(a) big(b) + big(a) small(b) + big(a) big(b) in that order (the
// dropped small(a) small(b) is below f32 rounding); each k-step's three
// products are summed apart and then added to the running sum in f32, since
// the tensor cores' own accumulation truncates. The operands come straight
// from wherever they lie (shared or device memory) through accessor functors
// that also mask the ragged edges; no staging, so a warp keeps the loads of
// several k-steps in flight. Every element of C is summed by one warp,
// k-step after k-step in increasing k, so the result does not depend on the
// launch and two launches give bit-identical output. No float atomics
// anywhere.
#pragma once

#include <stdint.h>

namespace mz_tc {

// x rounded to TF32 (10 mantissa bits, ties away from zero), the rounding
// of cvt.rna.tf32.f32, in two integer operations: cvt runs at a quarter of
// the rate of integer and f32 arithmetic, and the split converts every
// operand it reads.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b for one m16n8k8 TF32 fragment, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for one warp's (16 FM) x (8 FN) tile, with A(m, k) =
// A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn] counted from the
// tile's corner, M rows and N columns of it valid (at least one each) and
// K deep. Rows past M read row M - 1 and columns past N read column N - 1:
// their sums are garbage that the caller does not store. k past K reads 0.
// acc[i][j] holds the fragment of rows 16i + (g, g + 8) and columns
// 8j + (2t, 2t + 1), g = lane / 4, t = lane % 4, as c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// The loop over whole k-steps carries no bounds checks and walks pointers
// fixed per lane: the products of these kernels are small, and their cost is
// the instructions and the latencies around the mma. The B operands of
// kChunk k-steps (and, with kPrefetchA, the A operands; A from shared memory
// is better loaded at each step) are loaded one chunk ahead of their use.
// The tensor cores add their products into the accumulator rounding toward
// zero, an error that grows with the number of additions, so each k-step's
// three products go into a fresh fragment that is then added to acc in f32
// (round to nearest).
template <int FM, int FN, int kChunk, bool kPrefetchA>
__device__ __forceinline__ void warp_tile(int M, int N, int K,
                                          const float* A, int sam, int sak,
                                          const float* B, int sbk, int sbn,
                                          float (&acc)[FM][FN][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa[FM][2];  // rows 16i + g + 8h, column t
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pa[i][h] = A + min(16 * i + g + 8 * h, M - 1) * sam + t * sak;
  const float* pb[FN];  // row t, column 8j + g
#pragma unroll
  for (int j = 0; j < FN; ++j)
    pb[j] = B + t * sbk + min(8 * j + g, N - 1) * sbn;

  // One k-step at k: the A fragment (masked past K when `tail`).
  auto load_a = [&](int k, bool tail, float (&av)[FM][4]) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int kk = k + (h >> 1) * 4;
        av[i][h] = (!tail || kk + t < K) ? pa[i][h & 1][kk * sak] : 0.f;
      }
  };
  auto load_b = [&](int k, bool tail, float (&bv)[FN][2]) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k + h * 4;
        bv[j][h] = (!tail || kk + t < K) ? pb[j][kk * sbk] : 0.f;
      }
  };
  auto multiply = [&](const float (&av)[FM][4], const float (&bv)[FN][2]) {
    uint32_t ab[FM][4], as[FM][4], bb[FN][2], bs[FN][2];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) split(av[i][h], ab[i][h], as[i][h]);
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) split(bv[j][h], bb[j][h], bs[j][h]);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma(part, as[i], bb[j][0], bb[j][1]);
        mma(part, ab[i], bs[j][0], bs[j][1]);
        mma(part, ab[i], bb[j][0], bb[j][1]);
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] += part[h];
      }
  };

  // Whole chunks, software-pipelined: the next chunk's loads are in flight
  // while this one's products run.
  struct Stage {
    float a[kPrefetchA ? kChunk : 1][FM][4];
    float b[kChunk][FN][2];
  };
  auto load_chunk = [&](int k0, Stage& st) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (kPrefetchA) load_a(k0 + 8 * s, false, st.a[kPrefetchA ? s : 0]);
      load_b(k0 + 8 * s, false, st.b[s]);
    }
  };
  auto multiply_chunk = [&](int k0, const Stage& st) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (kPrefetchA) {
        multiply(st.a[kPrefetchA ? s : 0], st.b[s]);
      } else {
        float av[FM][4];
        load_a(k0 + 8 * s, false, av);
        multiply(av, st.b[s]);
      }
    }
  };
  constexpr int kStep = 8 * kChunk;
  const int chunks = (K & ~7) / kStep;
  if (chunks > 0) {
    Stage s0, s1;
    load_chunk(0, s0);
    int c = 0;
    for (; c + 2 <= chunks; c += 2) {
      load_chunk((c + 1) * kStep, s1);
      multiply_chunk(c * kStep, s0);
      if (c + 2 < chunks) load_chunk((c + 2) * kStep, s0);
      multiply_chunk((c + 1) * kStep, s1);
    }
    if (c < chunks) multiply_chunk(c * kStep, s0);
  }
  int k0 = chunks * kStep;
  for (; k0 < K; k0 += 8) {  // the last whole steps, then the ragged one
    const bool tail = k0 + 8 > K;
    float av[FM][4], bv[FN][2];
    load_a(k0, tail, av);
    load_b(k0, tail, bv);
    multiply(av, bv);
  }
}

// k-steps of one pipeline stage: about 16 registers of operands, so that
// two stages fit beside the sums.
template <int FM, int FN, bool kPrefetchA>
__host__ __device__ constexpr int chunk_steps() {
  return kPrefetchA ? (16 / (4 * FM + 2 * FN) > 0 ? 16 / (4 * FM + 2 * FN) : 1)
                    : (8 / FN > 0 ? 8 / FN : 1);
}

// Calls f(m, n, v) for each element of a warp tile's fragment that lies
// inside [0, M) x [0, N), with (m, n) relative to the tile's corner (m0, n0).
template <int FM, int FN, typename F>
__device__ __forceinline__ void for_each(const float (&acc)[FM][FN][4],
                                         int m0, int n0, int M, int N,
                                         const F& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = m0 + 16 * i + g + (h >> 1) * 8;
        const int n = n0 + 8 * j + 2 * t + (h & 1);
        if (m < M && n < N) f(m, n, acc[i][j][h]);
      }
}

// C = A B over [0, M) x [0, N), k < K, strides as warp_tile's: warp `warp`
// of `warps` takes the (16 FM) x (8 FN) tiles warp, warp + warps, ...
// (row-major over tiles) and calls store(m, n, sum) once for each element
// it owns. kPrefetchA: A lies in device memory (load it ahead with B), not
// in shared memory.
template <int FM, int FN, bool kPrefetchA, typename Store>
__device__ __forceinline__ void product(int M, int N, int K, const float* A,
                                        int sam, int sak, const float* B,
                                        int sbk, int sbn, const Store& store,
                                        int warp, int warps) {
  constexpr int TM = 16 * FM, TN = 8 * FN;
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = (M + TM - 1) / TM * tiles_n;
  for (int tile = warp; tile < tiles; tile += warps) {
    const int m0 = tile / tiles_n * TM, n0 = tile % tiles_n * TN;
    float acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;
    warp_tile<FM, FN, chunk_steps<FM, FN, kPrefetchA>(), kPrefetchA>(
        M - m0, N - n0, K, A + m0 * sam, sam, sak, B + n0 * sbn, sbk, sbn,
        acc);
    for_each(acc, m0, n0, M, N, store);
  }
}

// C[m * scm + n * scn] (+)= sum_k A[m * sam + k * sak] B[k * sbk + n * sbn]
// (+ bias[n]) by all warps of the block, in 16 x 16 tiles, A and B in
// device memory. The caller synchronises the block before reading C. The
// operands are plain loads, so they may be data that other threads of the
// block wrote before a barrier.
__device__ __forceinline__ void gemm(int M, int N, int K, const float* A,
                                     int sam, int sak, const float* B,
                                     int sbk, int sbn, float* C, int scm,
                                     int scn, const float* bias,
                                     bool accumulate) {
  product<1, 2, true>(
      M, N, K, A, sam, sak, B, sbk, sbn,
      [=](int m, int n, float v) {
        if (bias != nullptr) v += bias[n];
        float* c = C + m * scm + n * scn;
        *c = accumulate ? *c + v : v;
      },
      threadIdx.x >> 5, blockDim.x >> 5);
}

}  // namespace mz_tc
