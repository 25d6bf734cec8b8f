// Lane-group building blocks of the MLP search kernel (fused_search.cu,
// fused_search_kernel), for Hopper (sm_90a): a group of G lanes (4 or 32,
// aligned inside its warp) owns one environment. Reductions over the
// group take log2 G shuffle rounds under the group's own mask, so groups of
// one warp may diverge; the dense layers split their outputs over the
// group's lanes and sum their inputs in order.
//
// The dense layers read the towers' weights from the block's shared memory.
//
// Every butterfly below combines a lane's value with its partner's by a
// commutative operation, so all lanes of a group end with the same bits. A
// reduction over a `span` of fewer than G lanes runs in every span of the
// group at once; the tree walk gives each span every action once (lane l
// takes the actions congruent to l modulo span), so that each span holds
// the whole result.
#pragma once

#include <math.h>

#include "warp_mlp.cuh"

namespace mz_group {

using mz_warp::elu;
using mz_warp::inv_value_transform;

template <int G>
struct Group {
  static_assert(G == 4 || G == 32, "G in {4, 32}");
  unsigned mask;  // the group's lanes in the warp
  int lane;       // lane within the group

  __device__ Group() {
    const int l = threadIdx.x & 31;
    lane = l & (G - 1);
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (l & ~(G - 1));
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ float shfl(float v, int o) const {
    return __shfl_xor_sync(mask, v, o);
  }
  __device__ __forceinline__ float max(float v, int span = G) const {
    for (int o = span / 2; o > 0; o >>= 1) v = fmaxf(v, shfl(v, o));
    return v;
  }
  __device__ __forceinline__ float sum(float v, int span = G) const {
    for (int o = span / 2; o > 0; o >>= 1) v += shfl(v, o);
    return v;
  }
  // Minimum of lo and maximum of hi in one pass of rounds, over `span`.
  __device__ __forceinline__ void min_max(float* lo, float* hi,
                                          int span = G) const {
    for (int o = span / 2; o > 0; o >>= 1) {
      *lo = fminf(*lo, shfl(*lo, o));
      *hi = fmaxf(*hi, shfl(*hi, o));
    }
  }
  // The larger score, ties to the lower action; every lane returns it.
  // Over `span` lanes (a power of two up to G): each span of the group
  // reduces on its own.
  __device__ __forceinline__ int argmax(float best, int best_a,
                                        int span = G) const {
    for (int o = span / 2; o > 0; o >>= 1) {
      const float ob = shfl(best, o);
      const int oa = __shfl_xor_sync(mask, best_a, o);
      if (ob > best || (ob == best && oa < best_a)) {
        best = ob;
        best_a = oa;
      }
    }
    return best_a;
  }
};

// The sum of term(j) over j < n in a whole warp's order (warp_mlp.cuh's
// lane-strided sums): leaf l < 32 adds j = l, l + 32, ... in turn, and the
// leaves meet in the butterfly l ^ 16, l ^ 8, ..., l ^ 1. A lane of a group
// holds the leaves congruent to its lane modulo G (leaf k of the lane is
// l = lane + k G) and runs the rounds past G in registers, so every G gives
// the same bits as a warp does (the one-warp-per-environment design agreed
// with the plain version to the checks' tolerances; this keeps its
// rounding). term(j) reads what the lane that owns j modulo G wrote; the
// callers compute the terms' inputs first in plain strided loops, which
// pipeline, and the tree only loads and adds.
//
// leaf_tree<K, k, s> is the lane's part of the butterfly over its leaves
// k, k + s, k + 2 s, ...: the rounds that pair leaf k with leaf k + s after
// the rounds of stride 2 s. Taken depth first, it keeps log2 K + 1 partial
// sums live rather than all K leaves.
template <int K, int k, int s, typename Leaf>
__device__ __forceinline__ float leaf_tree(const Leaf& leaf) {
  if constexpr (s >= K) {
    return leaf(k);
  } else {
    return leaf_tree<K, k, 2 * s>(leaf) + leaf_tree<K, k + s, 2 * s>(leaf);
  }
}

template <int G, typename T>
__device__ __forceinline__ float warp_order_sum(const Group<G>& g, int n,
                                                T term) {
  // At most one term a lane: the rounds past G add zeros, which is exact.
  if (n <= G) return g.sum(g.lane < n ? term(g.lane) : 0.f);
  const auto leaf = [&](int k) {
    const int j0 = g.lane + k * G;
    float a = j0 < n ? term(j0) : 0.f;
    if (j0 + 32 < n) {
      a += term(j0 + 32);
      for (int j = j0 + 64; j < n; j += 32) a += term(j);
    }
    return a;
  };
  return g.sum(leaf_tree<32 / G, 0, 1>(leaf));
}

// Each output y[j] = x[in] @ W[in, out] + b (+ extra[j]) of this lane:
// j = lane, lane + G, ..., R at a time so that R independent chains of
// multiply-adds share each x[i]; every chain sums its inputs in order, and
// `extra` (a one-hot input's row of W, or null) comes after them, as the
// one-hot's place at the end of the input would. f(j, y[j]) takes each.
// R is 4 for groups of 4 lanes, whose lanes hold several outputs of a layer,
// and 2 for whole warps, whose four chains would mostly be past the end of
// the layer (two measured faster at G = 32, four at G = 4).
// Inlined: out-of-line copies measured slower.
template <int G, typename F>
__device__ __forceinline__ void for_outputs(const Group<G>& g,
                                            const float* W, const float* b,
                                            const float* x, int in, int out,
                                            const float* extra, F f) {
  constexpr int R = G == 32 ? 2 : 4;
  for (int j0 = g.lane; j0 < out; j0 += R * G) {
    float acc[R];
    int col[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = 0.f;
      col[r] = min(j0 + r * G, out - 1);  // a past-the-end chain is dropped
    }
#pragma unroll 4
    for (int i = 0; i < in; ++i) {
      const float xi = x[i];
      const float* w = W + i * out;
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(xi, w[col[r]], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r * G;
      if (j < out)
        f(j, (extra != nullptr ? acc[r] + extra[j] : acc[r]) + b[j]);
    }
  }
}

// y[out] = ELU(x[in] @ W + b (+ extra)); the group's lanes split the
// outputs. y must not alias x.
template <int G>
__device__ __forceinline__ void dense_elu(const Group<G>& g, const float* W,
                                          const float* b, const float* x,
                                          float* y, int in, int out,
                                          const float* extra) {
  for_outputs<G>(g, W, b, x, in, out, extra,
              [&](int j, float v) { y[j] = elu(v); });
  g.sync();
}

// The h-support decode of a head of n bins over h[in]: the logits into
// buf[n], their softmax, the expectation over the bins -S..S, then h^-1 in
// its closed form, the plain version's (each lane reads back only the bins
// it wrote; the sums in a warp's order). Every lane returns the value; buf is free again when
// it returns.
template <int G>
__device__ __forceinline__ float decode_head(const Group<G>& g,
                                             const float* W, const float* b,
                                             const float* h, int in, int n,
                                             int support, float* buf) {
  float m = -INFINITY;
  for_outputs<G>(g, W, b, h, in, n, nullptr, [&](int j, float l) {
    buf[j] = l;
    m = fmaxf(m, l);
  });
  m = g.max(m);
  for (int j = g.lane; j < n; j += G) buf[j] = expf(buf[j] - m);
  const float s = warp_order_sum(g, n, [&](int j) { return buf[j]; });
  for (int j = g.lane; j < n; j += G) buf[j] = buf[j] / s;
  const float x = warp_order_sum(g, n, [&](int j) {
    return buf[j] * static_cast<float>(j - support);
  });
  g.sync();
  return inv_value_transform(x);
}

// softmax over the n logits at `logits` (shared or device memory) into
// out[n]; `logits` may be `out` when this lane wrote its own entries.
template <int G>
__device__ __forceinline__ void softmax_row(const Group<G>& g,
                                            const float* logits, float* out,
                                            int n) {
  float m = -INFINITY;
  for (int j = g.lane; j < n; j += G) m = fmaxf(m, logits[j]);
  m = g.max(m);
  for (int j = g.lane; j < n; j += G) out[j] = expf(logits[j] - m);
  const float s = warp_order_sum(g, n, [&](int j) { return out[j]; });
  for (int j = g.lane; j < n; j += G) out[j] = out[j] / s;
  g.sync();
}

}  // namespace mz_group
