// Warp-level building blocks of the kernels that run one small MLP per warp
// (the search kernel's MLP modes in fused_search.cu and the Stochastic
// MuZero forest in fused_smz.cu), for Hopper (sm_90a): warp reductions, the
// dense layer with lanes over the outputs, the h-support decode, softmax and
// the first-maximum argmax.
#pragma once

#include <math.h>

namespace mz_warp {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kHEps = 1e-3f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expf(x) - 1.f;
}

// h^-1 of muax_tpu/ops/support.py (eps 1e-3).
__device__ __forceinline__ float inv_value_transform(float x) {
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float t =
      (sqrtf(4.f * kHEps * (fabsf(x) + 1.f + kHEps) + 1.f) - 1.f) /
      (2.f * kHEps);
  return sign * (t * t - 1.f);
}

// y[out] = x[in] @ W[in, out] + b, then ELU if `act`; lanes split the
// outputs. y must not alias x.
__device__ void dense(const float* W, const float* b, const float* x,
                      float* y, int in, int out, bool act, int lane) {
  for (int j = lane; j < out; j += 32) {
    float acc = 0.f;
    for (int i = 0; i < in; ++i) acc = fmaf(x[i], W[i * out + j], acc);
    acc += b[j];
    y[j] = act ? elu(acc) : acc;
  }
  __syncwarp();
}

// softmax over n support logits (overwritten), expectation over the bins
// -S..S, then h^-1. Every lane returns the value.
__device__ float decode_support(float* logits, int n, int support, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, logits[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(logits[j] - m);
    logits[j] = e;
    s += e;
  }
  s = warp_sum(s);
  float x = 0.f;
  for (int j = lane; j < n; j += 32)
    x += (logits[j] / s) * static_cast<float>(j - support);
  x = warp_sum(x);
  __syncwarp();
  return inv_value_transform(x);
}

// softmax over n logits into out.
__device__ void softmax_into(const float* logits, float* out, int n,
                             int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, logits[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) s += expf(logits[j] - m);
  s = warp_sum(s);
  for (int j = lane; j < n; j += 32) out[j] = expf(logits[j] - m) / s;
  __syncwarp();
}

// Hidden ELU layers of one tower from `x`, ping-ponging between bufs[0] and
// bufs[1]; `p` walks the flat weights. Returns the last hidden activation and
// leaves in `*k` the index of the free buffer and in `*width` its width.
__device__ const float* run_hidden(const float*& p, const float* x, int in,
                                   const int* widths, int n, float* bufs[2],
                                   int* k, int* width, int lane) {
  for (int l = 0; l < n; ++l) {
    const int out = widths[l];
    dense(p, p + in * out, x, bufs[*k], in, out, true, lane);
    p += in * out + out;
    x = bufs[*k];
    *k ^= 1;
    in = out;
  }
  *width = in;
  return x;
}

// Warp argmax over per-lane (best, best_a): the larger score, ties to the
// lower action. Every lane returns the winning action.
__device__ __forceinline__ int warp_argmax(float best, int best_a) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oa = __shfl_xor_sync(kFull, best_a, o);
    if (ob > best || (ob == best && oa < best_a)) {
      best = ob;
      best_a = oa;
    }
  }
  return best_a;
}

}  // namespace mz_warp
