// The tensor-core tile product of tc_tile.cuh on its own, for the tests
// that hold it against a float64 product on the card
// (tests/test_torch_categorical_kernels.py). Not on any path of the port.

#include <cuda_runtime.h>

#include "tc_tile.cuh"

namespace {

template <int FM, int FN, bool kPrefetchA>
__global__ void __launch_bounds__(256)
tc_product_kernel(int M, int N, int K, const float* A, long sam, long sak,
                  const float* B, long sbk, long sbn, float* C) {
  mz_tc::product<FM, FN, kPrefetchA>(
      M, N, K, A, static_cast<int>(sam), static_cast<int>(sak), B,
      static_cast<int>(sbk), static_cast<int>(sbn),
      [=](int m, int n, float v) { C[static_cast<long>(m) * N + n] = v; },
      threadIdx.x >> 5, blockDim.x >> 5);
}

}  // namespace

extern "C" {

// C [M, N] (row-major) = A B with A(m, k) = A[m * sam + k * sak] and
// B(k, n) = B[k * sbk + n * sbn], by one block of 256 threads in warp tiles
// of 16 x 16 (shape 0, the learner's first pass), 16 x 8 (shape 1, the
// search) or 32 x 32 (shape 2, the weight-gradient pass). Returns a
// cudaError_t, or -1 for an unknown shape.
int mz_tc_product(int shape, int M, int N, int K, const float* A, long sam,
                  long sak, const float* B, long sbk, long sbn, float* C,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shape == 0)
    tc_product_kernel<1, 2, true>
        <<<1, 256, 0, st>>>(M, N, K, A, sam, sak, B, sbk, sbn, C);
  else if (shape == 1)
    tc_product_kernel<1, 1, false>
        <<<1, 256, 0, st>>>(M, N, K, A, sam, sak, B, sbk, sbn, C);
  else if (shape == 2)
    tc_product_kernel<2, 4, true>
        <<<1, 256, 0, st>>>(M, N, K, A, sam, sak, B, sbk, sbn, C);
  else
    return -1;
  return cudaGetLastError();
}

}  // extern "C"
