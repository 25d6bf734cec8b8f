// A block-wide f32 matrix product for the tiled kernels of the categorical
// family (the search kernel's categorical modes and the categorical learner
// kernel), for Hopper (sm_90a).
//
// C[m, n] (+)= sum_k A(m, k) B(k, n) (+ bias[n]) for the whole of C, computed
// by one block of kThreads threads, where A(m, k) = A[m * sam + k * sak] and
// B(k, n) = B[k * sbk + n * sbn] may lie in device or shared memory and be
// transposed either way. The block walks C in BM x BN tiles; each tile's
// k-chunks of kBK pass through shared memory, and each thread keeps a
// 4 x TN micro-tile of sums in registers. Every element of C is summed by
// one thread in increasing k with fmaf, so the result does not depend on the
// launch and two launches give bit-identical output. Plain FMA: the tensor
// cores (wgmma), TMA staging and double buffering are left for later.
#pragma once

namespace mz_tile {

constexpr int kThreads = 256;
constexpr int kBK = 16;
// Floats of shared memory block_gemm needs, for its largest tile.
constexpr int kSmemFloats = kBK * (16 + 256);

template <int BM, int BN>
__device__ void block_gemm(int M, int N, int K, const float* A, long sam,
                           long sak, const float* B, long sbk, long sbn,
                           float* C, long scm, long scn, const float* bias,
                           bool accumulate, float* smem) {
  constexpr int TN = BM * BN / (kThreads * 4);  // micro-tile: 4 x TN
  constexpr int NT = BN / TN;                   // threads along n
  static_assert(TN >= 1 && (BM / 4) * NT == kThreads, "tile shape");
  float* As = smem;             // [kBK][BM]
  float* Bs = smem + kBK * BM;  // [kBK][BN]
  const int t = threadIdx.x;
  const int tm = t / NT, tn = t % NT;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][TN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kBK) {
        // Stage the chunk; the index runs fastest along the unit stride.
        for (int idx = t; idx < kBK * BM; idx += kThreads) {
          const int kk = sak == 1 ? idx % kBK : idx / BM;
          const int mm = sak == 1 ? idx / kBK : idx % BM;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * BM + mm] = (m < M && k < K) ? A[m * sam + k * sak] : 0.f;
        }
        for (int idx = t; idx < kBK * BN; idx += kThreads) {
          const int nn = sbn == 1 ? idx % BN : idx / kBK;
          const int kk = sbn == 1 ? idx / BN : idx % kBK;
          const int n = n0 + nn, k = k0 + kk;
          Bs[kk * BN + nn] = (n < N && k < K) ? B[k * sbk + n * sbn] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(As + kk * BM + tm * 4);
          float b[TN];
          if constexpr (TN == 4) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(Bs + kk * BN + tn * 4);
            b[0] = b4.x;
            b[1] = b4.y;
            b[2] = b4.z;
            b[3] = b4.w;
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tn * TN + j];
          }
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tm * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tn * TN + j;
          if (n >= N) continue;
          float v = acc[i][j];
          if (bias != nullptr) v += bias[n];
          float* c = C + m * scm + n * scn;
          *c = accumulate ? *c + v : v;
        }
      }
    }
  }
}

// C = A B (+ bias) with the tile that suits the shape: 16-row tiles for the
// rows of a tile of environments or windows (wide, or narrow for a head),
// 64 x 64 for products with many rows (wide weight gradients). Callers
// synchronise the block before reading C.
__device__ inline void gemm(int M, int N, int K, const float* A, long sam,
                            long sak, const float* B, long sbk, long sbn,
                            float* C, long scm, long scn, const float* bias,
                            bool accumulate, float* smem) {
  if (M <= 128 && N <= 64)
    block_gemm<16, 64>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, bias,
                       accumulate, smem);
  else if (M <= 128)
    block_gemm<16, 256>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, bias,
                        accumulate, smem);
  else
    block_gemm<64, 64>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, bias,
                       accumulate, smem);
}

}  // namespace mz_tile
