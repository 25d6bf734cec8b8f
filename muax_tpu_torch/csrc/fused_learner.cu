// Fused MuZero learner: the K-step unrolled loss and its hand-derived
// backward for a batch of windows, for Hopper (sm_90a). The MLP spec runs
// mlp_tile_kernel and then mlp_finish_kernel (entry mz_fused_muzero_grad);
// the categorical LearnerSpec runs categorical_tile_kernel and the
// weight-gradient pass categorical_dw_kernel (entry
// mz_fused_categorical_grad). Both are described at their kernels.
//
// Replaces the TPU kernel muax_tpu/models/fused_learner.py `_make_kernel`
// (raw mode), which `_run_kernel` launches through pl.pallas_call
// (muax_tpu/models/fused_learner.py:665). The plain PyTorch version of the
// same function is autograd over `muzero_loss`
// (`fused_muzero_grad_raw_reference` in
// muax_tpu_torch/models/fused_learner.py).
//
// What it computes, per window: the representation of the start
// observation, K steps of prediction and dynamics (the dynamics input is
// concat(s, one_hot(a))), the three cross-entropies against two-hot targets
// built here from the raw scalar rows, and the backward pass: softmax minus
// target for each head, the min-max normaliser's tie-splitting subgradient,
// and the gradient into the hidden state scaled by `gradient_scale` where it
// enters the dynamics. Weight gradients are summed over the batch with each
// window's `coef` = weight / denom / B, and L2 (`l2_coef * p`) is added.
// Nothing uses float atomics and every sum runs in a fixed order, so two
// launches on the same inputs give bit-identical gradients.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "tc_tile.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxLin = 3 * kMaxLayers + 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHEps = 1e-3f;
constexpr float kMMEps = 1e-8f;

// Reductions over a group of G neighbouring lanes (G a power of two, at
// most 32); `mask` names the group's lanes. G = 32 is the whole warp.
template <int G>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_min(float v, unsigned mask) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  return group_max<32>(v, kFull);
}

__device__ __forceinline__ float warp_min(float v) {
  return group_min<32>(v, kFull);
}

__device__ __forceinline__ float warp_sum(float v) {
  return group_sum<32>(v, kFull);
}

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expf(x) - 1.f;
}

// elu'(x) from y = elu(x).
__device__ __forceinline__ float elu_grad(float y) {
  return y > 0.f ? 1.f : y + 1.f;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// h^-1 of muax_tpu/ops/support.py (eps 1e-3).
__device__ __forceinline__ float inv_value_transform(float x) {
  const float t =
      (sqrtf(4.f * kHEps * (fabsf(x) + 1.f + kHEps) + 1.f) - 1.f) /
      (2.f * kHEps);
  return sign_of(x) * (t * t - 1.f);
}

// Two-hot of h(x) over the bins -S..S (ops/support.py scalar_to_support).
struct TwoHot {
  float low, high, ph;
  int support;
  __device__ float operator()(int j) const {
    const float bin = static_cast<float>(j - support);
    return (bin == low ? 1.f - ph : 0.f) + (bin == high ? ph : 0.f);
  }
};

__device__ TwoHot two_hot(float x, int support) {
  const float S = static_cast<float>(support);
  float y = sign_of(x) * (sqrtf(fabsf(x) + 1.f) - 1.f) + kHEps * x;
  y = fminf(fmaxf(y, -S), S);
  const float low = floorf(y);
  return TwoHot{low, fminf(low + 1.f, S), y - low, support};
}

// y = (x - min) / max(max - min, 1e-8), by a group of G lanes (gl: the
// lane's place in it).
template <int G = 32>
__device__ void minmax(const float* x, float* y, int n, int gl,
                       unsigned mask = kFull) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = gl; j < n; j += G) {
    lo = fminf(lo, x[j]);
    hi = fmaxf(hi, x[j]);
  }
  lo = group_min<G>(lo, mask);
  hi = group_max<G>(hi, mask);
  const float d = fmaxf(hi - lo, kMMEps);
  for (int j = gl; j < n; j += G) y[j] = (x[j] - lo) / d;
  __syncwarp(mask);
}

// Subgradient of minmax at x for the output gradient dy, as jax.grad gives
// it: the gradient of the min (max) is split evenly over tied entries, and
// the range gets none while the 1e-8 floor binds.
__device__ void minmax_bwd(const float* x, const float* dy, float* dx, int n,
                           int lane) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    lo = fminf(lo, x[j]);
    hi = fmaxf(hi, x[j]);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const float range = hi - lo;
  const float d = fmaxf(range, kMMEps);
  float n_lo = 0.f, n_hi = 0.f, sg = 0.f, sgy = 0.f;
  for (int j = lane; j < n; j += 32) {
    n_lo += x[j] == lo ? 1.f : 0.f;
    n_hi += x[j] == hi ? 1.f : 0.f;
    sg += dy[j];
    sgy += dy[j] * ((x[j] - lo) / d);
  }
  n_lo = warp_sum(n_lo);
  n_hi = warp_sum(n_hi);
  sg = warp_sum(sg);
  sgy = warp_sum(sgy);
  const float active = range > kMMEps ? 1.f : 0.f;
  for (int j = lane; j < n; j += 32) {
    const float m = (x[j] == lo ? 1.f : 0.f) / n_lo;
    const float mm = (x[j] == hi ? 1.f : 0.f) / n_hi;
    dx[j] = (dy[j] - m * sg - active * sgy * (mm - m)) / d;
  }
  __syncwarp();
}

// Logits z[n] -> softmax probabilities in place; returns the cross-entropy
// -sum_j t(j) log_softmax(z)_j (the same on every lane).
template <typename Target>
__device__ float softmax_ce(float* z, int n, const Target& t, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, z[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) s += expf(z[j] - m);
  const float log_s = logf(warp_sum(s));
  float ce = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float ls = (z[j] - m) - log_s;
    ce -= t(j) * ls;
    z[j] = expf(ls);
  }
  ce = warp_sum(ce);
  __syncwarp();
  return ce;
}

// ---- the MLP spec: a tile pass and a finish pass, or, for wide towers, a
// cluster pass and the weight-gradient pass --------------------------------
//
// Replaces the TPU kernel with the MLP spec (elu towers, h-support heads).
// The TPU kernel lays the batch across the 128 lanes and the features on
// sublanes (muax_tpu/models/fused_learner.py:287-289); here the windows are
// the rows of tensor-core tile products.
//
// mlp_tile_kernel: a block owns a tile of kTile = 16 windows, the M of
// mma.sync m16n8k8. Each layer of the forward and of the backward is one
// [rows, in] x [in, out] product on the tensor cores (tc_tile.cuh, 3xTF32),
// its bias and elu (or elu's derivative) applied as the products' sums are
// stored; its rows are the tile's 16 windows for the representation and
// for each dynamics step, and all K steps' 16 K rows at once for the
// prediction, which only the dynamics chain feeds. The row-wise work (the
// softmax cross-entropies over the bins with their gradient, the min-max
// normaliser and its subgradient) runs on a thread (the bins) or 8 lanes
// (the state) a row, and v0 (h^-1 of the first value) on a warp a row.
// The towers' weights stay in shared memory,
// and so does the arena (the forward's activations and the backward's
// gradients, in rows padded to 4 mod 8 floats so that a product's lanes
// read distinct banks) where it fits beside them; else the arena lies in a
// device scratch (long unrolls: `mlp_learner_plan` in
// models/fused_learner.py decides). Towers wider than a block's shared
// memory take mlp_cluster_kernel below. Each
// linear's weight gradient is one product over the block's rows, dW = dz^T
// x, and its bias gradient a column sum, both in a fixed order, written to
// the block's row of a [G, n_weights] scratch: the prediction tower's by
// the warps the first step of the dynamics' backward leaves idle (where it
// leaves any), the rest last.
//
// mlp_finish_kernel: grads = l2_coef w + the G block rows added in a fixed
// order (each block of it 32 weights, its 8 warps a slice of the rows each,
// the slices added in order), and l2 in the last block.
//
// What bounds it: per window about 9,000 multiply-adds forward and twice
// that backward at the flagship widths, so a launch of 4,096 windows is
// about 0.22 GFLOP: 3.3 us at the f32 peak. What limits it is latency: a
// tile's chain of about 40 dependent stages of products and row passes,
// two blocks an SM. The design puts each link on 16 windows at once and
// spreads it over a block's 8 warps, instead of one warp walking one
// window's 120 small layers.

constexpr int kTile = 16;         // windows of a block
constexpr int kThreads = 256;     // mlp_tile_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 16, kTN = 16;  // a warp's tile of a product
constexpr int kNormLanes = 8;      // lanes of a row of the normaliser
constexpr int kFinishThreads = 256;
constexpr int kFinishCols = 32;    // weights of a mlp_finish_kernel block
constexpr int kFinishSlices = kFinishThreads / kFinishCols;

// Floats of a row of n: n padded to 4 mod 8, so that the 8 rows (or
// columns) that a tile product's lanes read at once fall in distinct banks.
__host__ __device__ constexpr int padded(int n) {
  return n <= 4 ? 4 : (n + 3) / 8 * 8 + 4;
}

struct MlpArgs {
  int B, ld, O, E, A, S41, support, K;
  int n_repr, n_pred, n_dyn, n_lin;
  // Linear l, in the modules' parameter order (representation hidden layers
  // and head; prediction hidden layers, value and policy heads; dynamics
  // hidden layers, reward and next-state heads): W [out, in] and b [out] at
  // off[l] of the flat parameters, which shared memory holds as they are.
  int off[kMaxLin], din[kMaxLin], dout[kMaxLin];
  // In the block's arena: the linear's rows (kTile for the representation,
  // K kTile for the others, step-major), its input rows x (stride xs), its
  // outputs y and their gradient dz (stride ys; a softmax head's dz takes
  // the place of its logits).
  int rows[kMaxLin], xs[kMaxLin], ys[kMaxLin];
  long x[kMaxLin], y[kMaxLin], dz[kMaxLin];
  // Weight-gradient work: dW tiles before linear l, bias columns before it.
  int tile0[kMaxLin + 1], col0[kMaxLin + 1];
  // The arena's other buffers: the start observations [kTile, x0s]; the
  // tile's raw rows of actions, rewards, returns, policies and masks, and
  // its coef [4 K + K A + 1, kTile]; the dynamics input concat(s_i,
  // one_hot(a_i)) [K kTile, sas], whose first E columns are the
  // prediction's input; the gradient into s_i [K kTile, dss]; the
  // cross-entropies [3, K kTile] and v0 [kTile].
  long x0, rt, sa, ds, ce;
  int x0s, sas, dss;
  int r_obs, r_action, r_reward, r_rn, r_pi, r_mask;
  int n_weights, smem_weights;
  long arena_floats;
  float gradient_scale;
};

// One product term: sum_k A(m, k) B(k, n), A(m, k) = A[m * sam + k * sak],
// B(k, n) = B[k * sbk + n * sbn], k < K.
struct Term {
  const float* A;
  int sam, sak;
  const float* B;
  int sbk, sbn, K;
};

// C = the sum of one or two terms over [0, M) x [0, N). (Two fields, not
// an array: an array indexed at run time would go to local memory.)
struct Prod {
  int M, N, nterm;
  Term t0, t1;
};

__device__ __forceinline__ Prod prod(int M, int N, const Term& a) {
  return Prod{M, N, 1, a, a};
}

__device__ __forceinline__ Prod prod(int M, int N, const Term& a,
                                     const Term& b) {
  return Prod{M, N, 2, a, b};
}

// What a tile product does with its sums v at (m, n): C[m * ldc + n] =
// v + bias[n] (kLinear), elu(v + bias[n]) (kElu), v elu'(y[m * ldc + n])
// with y the layer's activations (kEluGrad), v (kSet), or C + scale v
// (kAddScaled).
enum Epilogue { kLinear, kElu, kEluGrad, kSet, kAddScaled };

struct Out {
  float* C;
  const float* aux;  // the bias (kLinear, kElu) or the activations y
  int ldc, mode;
  float scale;
};

// Stores the sum v of a product at (m, n) as o says.
__device__ __forceinline__ void store_out(const Out& o, int m, int n,
                                          float v) {
  float* c = o.C + m * o.ldc + n;
  switch (o.mode) {
    case kLinear: *c = v + o.aux[n]; break;
    case kElu: *c = elu(v + o.aux[n]); break;
    case kEluGrad: *c = v * elu_grad(o.aux[m * o.ldc + n]); break;
    case kSet: *c = v; break;
    default: *c = *c + o.scale * v;
  }
}

// One warp's kTM x kTN tile at (m0, n0) of p, its terms added into one set
// of sums in order, stored as o says.
template <bool kPrefA>
__device__ __forceinline__ void tile_job(const Prod& p, const Out& o,
                                         int m0, int n0) {
  float acc[1][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[0][j][h] = 0.f;
  auto term = [&](const Term& t) {
    mz_tc::warp_tile<1, 2, mz_tc::chunk_steps<1, 2, kPrefA>(), kPrefA>(
        p.M - m0, p.N - n0, t.K, t.A + static_cast<long>(m0) * t.sam, t.sam,
        t.sak, t.B + static_cast<long>(n0) * t.sbn, t.sbk, t.sbn, acc);
  };
  term(p.t0);
  if (p.nterm > 1) term(p.t1);
  mz_tc::for_each(acc, m0, n0, p.M, p.N,
                  [&](int m, int n, float v) { store_out(o, m, n, v); });
}

// A stage of the tile pass: the tiles of p1 and then of p2 (none when
// p2.M is 0) dealt to the block's warps in turn; the warps left without a
// tile run idle(w, n) as the w-th of n; then the block's barrier.
template <bool kPrefA, typename Idle>
__device__ __forceinline__ void stage(const Prod& p1, const Out& o1,
                                      const Prod& p2, const Out& o2,
                                      const Idle& idle) {
  const int warp = threadIdx.x >> 5;
  const int n1 = (p1.N + kTN - 1) / kTN;
  const int t1 = (p1.M + kTM - 1) / kTM * n1;
  const int n2 = (p2.N + kTN - 1) / kTN;
  const int t2 = p2.M > 0 ? (p2.M + kTM - 1) / kTM * n2 : 0;
  for (int tile = warp; tile < t1 + t2; tile += kWarps) {
    if (tile < t1) {
      tile_job<kPrefA>(p1, o1, tile / n1 * kTM, tile % n1 * kTN);
    } else {
      const int u = tile - t1;
      tile_job<kPrefA>(p2, o2, u / n2 * kTM, u % n2 * kTN);
    }
  }
  if (warp >= t1 + t2) idle(warp - t1 - t2, kWarps - t1 - t2);
  __syncthreads();
}

template <bool kPrefA>
__device__ __forceinline__ void stage(const Prod& p1, const Out& o1,
                                      const Prod& p2, const Out& o2) {
  stage<kPrefA>(p1, o1, p2, o2, [](int, int) {});
}

template <bool kPrefA>
__device__ __forceinline__ void stage(const Prod& p1, const Out& o1) {
  Prod none = p1;
  none.M = 0;
  stage<kPrefA>(p1, o1, none, o1);
}

// Copies a float (or, 16-byte aligned, four) from device memory to shared
// memory (cp.async): the copies of a thread are in flight together until
// cp_wait.
__device__ __forceinline__ void cp_float(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_float4(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The row passes take G lanes a row (gl: a lane's place among them,
// mask: the row's lanes) and sum in the order of a group of 8 lanes: the
// partial sum of k < 8 over j = k mod 8 in increasing j, then the
// butterfly of group_sum<8>; lane gl keeps the partials of k = gl + G q.
// The same sums at any G, so that the row passes give one result however
// their lanes are dealt.
template <int G>
__device__ __forceinline__ float sum8(float (&a)[8 / G], unsigned mask) {
#pragma unroll
  for (int o = 4; o >= G; o >>= 1)
#pragma unroll
    for (int q = 0; q < o / G; ++q) a[q] = a[q] + a[q + o / G];
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) a[0] += __shfl_xor_sync(mask, a[0], o);
  return a[0];
}

// Softmax cross-entropy of logits z[n] against t(j), by one thread; z
// becomes cm (softmax(z) - t) in place. Returns the cross-entropy.
template <typename Target>
__device__ float softmax_ce_grad(float* z, int n, const Target& t,
                                 float cm) {
  float m = -INFINITY;
  for (int j = 0; j < n; ++j) m = fmaxf(m, z[j]);
  float s[8] = {}, ce[8] = {};
  for (int j0 = 0; j0 < n; j0 += 8)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (j0 + q < n) s[q] += expf(z[j0 + q] - m);
  const float log_s = logf(sum8<1>(s, 0u));
  for (int j0 = 0; j0 < n; j0 += 8)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q;
      if (j >= n) continue;
      const float ls = (z[j] - m) - log_s;
      const float tj = t(j);
      ce[q] -= tj * ls;
      z[j] = cm * (expf(ls) - tj);
    }
  return sum8<1>(ce, 0u);
}

// minmax_bwd (the normaliser's subgradient) with its sums in the order
// above, and its divisions as products with reciprocals (the backward
// feeds no priority).
template <int G>
__device__ void norm_bwd_row(const float* x, const float* dy, float* dx,
                             int n, int gl, unsigned mask) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = gl; j < n; j += G) {
    lo = fminf(lo, x[j]);
    hi = fmaxf(hi, x[j]);
  }
  lo = group_min<G>(lo, mask);
  hi = group_max<G>(hi, mask);
  const float range = hi - lo;
  const float inv_d = 1.f / fmaxf(range, kMMEps);
  float n_lo[8 / G] = {}, n_hi[8 / G] = {}, sg[8 / G] = {}, sgy[8 / G] = {};
  for (int j0 = 0; j0 < n; j0 += 8)
#pragma unroll
    for (int q = 0; q < 8 / G; ++q) {
      const int j = j0 + gl + G * q;
      if (j >= n) continue;
      n_lo[q] += x[j] == lo ? 1.f : 0.f;
      n_hi[q] += x[j] == hi ? 1.f : 0.f;
      sg[q] += dy[j];
      sgy[q] += dy[j] * ((x[j] - lo) * inv_d);
    }
  const float inv_lo = 1.f / sum8<G>(n_lo, mask);
  const float inv_hi = 1.f / sum8<G>(n_hi, mask);
  const float g = sum8<G>(sg, mask), gy = sum8<G>(sgy, mask);
  const float active = range > kMMEps ? 1.f : 0.f;
  for (int j = gl; j < n; j += G) {
    const float m = x[j] == lo ? inv_lo : 0.f;
    const float mm = x[j] == hi ? inv_hi : 0.f;
    dx[j] = (dy[j] - m * g - active * gy * (mm - m)) * inv_d;
  }
  if (G > 1) __syncwarp(mask);
}

// The layout tables of g are indexed at run time: __grid_constant__ keeps
// them in the constant bank, where a copy per thread would spill 2 KB a
// thread to local memory.
template <bool kSmemArena>
__global__ void __launch_bounds__(kThreads, 2)
mlp_tile_kernel(const float* __restrict__ raw, const float* __restrict__ coef,
                const float* __restrict__ weights, float* __restrict__ arena,
                float* __restrict__ partial, float* __restrict__ met,
                const __grid_constant__ MlpArgs g) {
  constexpr bool kPrefA = !kSmemArena;  // operands in device memory
  extern __shared__ __align__(16) float smem[];
  const float* Ws = smem;
  float* base = kSmemArena ? smem + g.smem_weights
                           : arena + blockIdx.x * g.arena_floats;
  const int w0 = blockIdx.x * kTile;
  const int T = kTile, K = g.K, R = K * T, E = g.E, A = g.A, S41 = g.S41;
  const size_t ld = static_cast<size_t>(g.ld);
  const int l_rhead = g.n_repr, l_pred0 = l_rhead + 1;
  const int l_value = l_pred0 + g.n_pred, l_policy = l_value + 1;
  const int l_dyn0 = l_policy + 1, l_reward = l_dyn0 + g.n_dyn;
  const int l_state = l_reward + 1;
  // The tile's copy of its raw rows: step i of window t in a block of rows
  // starting at `first` (0 actions, K rewards, 2 K returns, q_pi policies
  // of A rows a step, q_mask masks, q_coef the coef). Windows past the
  // batch read 0, so that they compute on zeros and, with cm = 0, add
  // nothing to any gradient.
  float* rt = base + g.rt;
  auto tile_raw = [&](int first, int i, int t) {
    return rt[(first + i) * T + t];
  };
  const int q_pi = 3 * K, q_mask = q_pi + K * A, q_coef = q_mask + K;
  auto cm_of = [&](int i, int t) {
    return tile_raw(q_coef, 0, t) * tile_raw(q_mask, i, t);
  };
  auto at = [&](long off, int row, int stride) {
    return base + off + static_cast<long>(row) * stride;
  };
  // Linear l on rows [r0, r0 + M): its input times W^T.
  auto fwd_term = [&](int l, int r0) {
    return Term{at(g.x[l], r0, g.xs[l]), g.xs[l], 1, Ws + g.off[l], 1,
                g.din[l], g.din[l]};
  };
  // Linear l's dz on rows [r0, r0 + M) times W: the gradient at its input.
  auto bwd_term = [&](int l, int r0) {
    return Term{at(g.dz[l], r0, g.ys[l]), g.ys[l], 1, Ws + g.off[l],
                g.din[l], 1, g.dout[l]};
  };
  // Outputs: y = x W^T + b (then elu), and dz of layer lp = v elu'(y).
  auto fwd_out = [&](int l, int r0, bool act) {
    return Out{at(g.y[l], r0, g.ys[l]), Ws + g.off[l] + g.din[l] * g.dout[l],
               g.ys[l],
               act ? kElu : kLinear, 0.f};
  };
  auto bwd_out = [&](int lp, int r0) {
    return Out{at(g.dz[lp], r0, g.ys[lp]), at(g.y[lp], r0, g.ys[lp]),
               g.ys[lp], kEluGrad, 0.f};
  };
  auto fwd = [&](int l, int r0, int M, bool act) {
    stage<kPrefA>(prod(M, g.dout[l], fwd_term(l, r0)), fwd_out(l, r0, act));
  };
  // dz of layer l - 1 from dz of layer l.
  auto bwd = [&](int l, int r0, int M) {
    stage<kPrefA>(prod(M, g.din[l], bwd_term(l, r0)), bwd_out(l - 1, r0));
  };
  // The row passes: the normaliser's on kNormLanes lanes a row of the
  // state, the softmax heads' on a thread a row of bins.
  const int lane = threadIdx.x & 31;
  const int nl = threadIdx.x % kNormLanes;
  const unsigned nmask = ((1u << kNormLanes) - 1) << (lane & -kNormLanes);
  // Rows of s_i from the pre-norm state of linear l (row block `src`):
  // minmax, then one_hot(a_i).
  auto next_state = [&](int l, int src, int i) {
    for (int t = threadIdx.x / kNormLanes; t < T;
         t += kThreads / kNormLanes) {
      float* s = at(g.sa, i * T + t, g.sas);
      minmax<kNormLanes>(at(g.y[l], src + t, g.ys[l]), s, E, nl, nmask);
      const int a = static_cast<int>(tile_raw(0, i, t));
      for (int j = nl; j < A; j += kNormLanes) s[E + j] = j == a ? 1.f : 0.f;
    }
    __syncthreads();
  };
  // The normaliser's subgradient: the gradient at the pre-norm rows x
  // (linear l, rows r0..) from the gradient into s at rows ds0.. of ds.
  auto norm_bwd = [&](int l, int r0, int ds0) {
    for (int t = threadIdx.x / kNormLanes; t < T;
         t += kThreads / kNormLanes)
      norm_bwd_row<kNormLanes>(at(g.y[l], r0 + t, g.ys[l]),
                               at(g.ds, ds0 + t, g.dss),
                               at(g.dz[l], r0 + t, g.ys[l]), E, nl, nmask);
    __syncthreads();
  };
  float* ce = base + g.ce;

  // ---- forward ------------------------------------------------------------
  // The weights, the start observations and the tile's raw rows (0 past
  // the batch), the copies in flight at once (the arena's only where it
  // lies in shared memory).
  const int warp = threadIdx.x >> 5;
  {
    const int n4 = reinterpret_cast<size_t>(weights) % 16 == 0
                       ? g.n_weights / 4 * 4 : 0;
    for (int i = 4 * threadIdx.x; i < n4; i += 4 * kThreads)
      cp_float4(smem + i, weights + i);
    for (int i = n4 + threadIdx.x; i < g.n_weights; i += kThreads)
      cp_float(smem + i, weights + i);
  }
  auto copy_raw = [&](float* dst, const float* src, int t) {
    if (w0 + t >= g.B) {
      *dst = 0.f;
    } else if (kSmemArena) {
      cp_float(dst, src + w0 + t);
    } else {
      *dst = src[w0 + t];
    }
  };
  for (int i = threadIdx.x; i < T * g.O; i += kThreads)
    copy_raw(base + g.x0 + (i % T) * g.x0s + i / T,
             raw + (g.r_obs + i / T) * ld, i % T);
  for (int i = threadIdx.x; i < q_coef * T; i += kThreads) {
    const int q = i / T;
    const int row = q < K        ? g.r_action + q
                    : q < 2 * K  ? g.r_reward + q - K
                    : q < q_pi   ? g.r_rn + q - 2 * K
                    : q < q_mask ? g.r_pi + q - q_pi
                                 : g.r_mask + q - q_mask;
    copy_raw(rt + i, raw + row * ld, i % T);
  }
  for (int t = threadIdx.x; t < T; t += kThreads)
    copy_raw(rt + q_coef * T + t, coef, t);
  cp_wait();
  {  // the last step's next state feeds nothing: its gradient is 0
    float* d = at(g.dz[l_state], (K - 1) * T, g.ys[l_state]);
    for (int i = threadIdx.x; i < T * g.ys[l_state]; i += kThreads)
      d[i] = 0.f;
  }
  __syncthreads();
  for (int l = 0; l <= l_rhead; ++l) fwd(l, 0, T, l < l_rhead);
  next_state(l_rhead, 0, 0);
  for (int i = 0; i < K; ++i) {
    const int r0 = i * T;
    for (int l = l_dyn0; l < l_reward; ++l) fwd(l, r0, T, true);
    stage<kPrefA>(prod(T, S41, fwd_term(l_reward, r0)),
                  fwd_out(l_reward, r0, false),
                  prod(T, E, fwd_term(l_state, r0)),
                  fwd_out(l_state, r0, false));
    if (i + 1 < K) next_state(l_state, r0, i + 1);
  }
  for (int l = l_pred0; l < l_value; ++l) fwd(l, 0, R, true);
  stage<kPrefA>(prod(R, S41, fwd_term(l_value, 0)),
                fwd_out(l_value, 0, false),
                prod(R, A, fwd_term(l_policy, 0)),
                fwd_out(l_policy, 0, false));
  // v0 = h^-1 of the first step's expected value, a warp a window, each
  // lane summing its bins j = lane + 32 q in order and the warp's
  // butterfly adding the lanes, as the one-warp-per-window kernel summed.
  // The priorities |v0 - z|^0.5 amplify v0's rounding where v0 is near z;
  // the 8-lane order of the row passes left them further from the plain
  // version's on one of tools/kernel_split.py priority_probe's inputs.
  for (int t = warp; t < T; t += kWarps) {
    const float* z = at(g.y[l_value], t, g.ys[l_value]);
    float m = -INFINITY;
    for (int j = lane; j < S41; j += 32) m = fmaxf(m, z[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < S41; j += 32) s += expf(z[j] - m);
    const float log_s = logf(warp_sum(s));
    float ev = 0.f;
    for (int j = lane; j < S41; j += 32)
      ev += expf((z[j] - m) - log_s) * static_cast<float>(j - g.support);
    ev = warp_sum(ev);
    if (lane == 0) ce[3 * R + t] = inv_value_transform(ev);
  }
  __syncthreads();
  // The three heads' cross-entropies and dz over every step.
  for (int q = threadIdx.x; q < 3 * R; q += kThreads) {
    const int r = q % R, i = r / T, t = r % T;
    if (q >= 2 * R) {
      ce[q] = softmax_ce_grad(at(g.y[l_reward], r, g.ys[l_reward]), S41,
                              two_hot(tile_raw(K, i, t), g.support),
                              cm_of(i, t));
    } else if (q < R) {
      ce[q] = softmax_ce_grad(at(g.y[l_value], r, g.ys[l_value]), S41,
                              two_hot(tile_raw(2 * K, i, t), g.support),
                              cm_of(i, t));
    } else {
      ce[q] = softmax_ce_grad(
          at(g.y[l_policy], r, g.ys[l_policy]), A,
          [&](int j) { return tile_raw(q_pi + i * A, j, t); }, cm_of(i, t));
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T && w0 + t < g.B; t += kThreads) {
    float v_sum = 0.f, p_sum = 0.f, r_sum = 0.f;
    for (int i = 0; i < K; ++i) {
      const float mask = tile_raw(q_mask, i, t);
      v_sum += mask * ce[i * T + t];
      p_sum += mask * ce[R + i * T + t];
      r_sum += mask * ce[2 * R + i * T + t];
    }
    const int w = w0 + t;
    met[w] = v_sum;
    met[g.B + w] = p_sum;
    met[2 * g.B + w] = r_sum;
    met[3 * g.B + w] = ce[3 * R + t];
  }

  // The weight gradients of linears [a0, a1) and [b0, b1), into the
  // block's row of partial, by the w-th of n warps: dW = dz^T x over the
  // linear's rows (a warp a tile, rows in order) and db = the column sums
  // of dz (a thread a column, rows in order).
  float* part = partial + static_cast<size_t>(blockIdx.x) * g.n_weights;
  auto weight_grads = [&](int a0, int a1, int b0, int b1, int w, int n) {
    const int ta = g.tile0[a1] - g.tile0[a0], tb = g.tile0[b1] - g.tile0[b0];
    for (int v = w; v < ta + tb; v += n) {
      const int tile = v < ta ? g.tile0[a0] + v : g.tile0[b0] + v - ta;
      int l = 0;
      while (tile >= g.tile0[l + 1]) ++l;
      const int in = g.din[l], tn = (in + kTN - 1) / kTN;
      const int u = tile - g.tile0[l];
      const Term t{base + g.dz[l], 1, g.ys[l], base + g.x[l], g.xs[l], 1,
                   g.rows[l]};
      tile_job<kPrefA>(prod(g.dout[l], in, t),
                       Out{part + g.off[l], nullptr, in, kSet, 0.f},
                       u / tn * kTM, u % tn * kTN);
    }
    const int ca = g.col0[a1] - g.col0[a0], cb = g.col0[b1] - g.col0[b0];
    for (int v = w * 32 + lane; v < ca + cb; v += n * 32) {
      const int c = v < ca ? g.col0[a0] + v : g.col0[b0] + v - ca;
      int l = 0;
      while (c >= g.col0[l + 1]) ++l;
      const int o = c - g.col0[l], ys = g.ys[l];
      const float* dz = base + g.dz[l] + o;
      float sum = 0.f;
#pragma unroll 8
      for (int r = 0; r < g.rows[l]; ++r) sum += dz[r * ys];
      part[g.off[l] + g.din[l] * g.dout[l] + o] = sum;
    }
  };

  // ---- backward: prediction over every step --------------------------------
  stage<kPrefA>(prod(R, g.din[l_value], bwd_term(l_value, 0),
                     bwd_term(l_policy, 0)),
                bwd_out(l_value - 1, 0));
  for (int l = l_value - 1; l > l_pred0; --l) bwd(l, 0, R);
  stage<kPrefA>(prod(R, E, bwd_term(l_pred0, 0)),
                Out{base + g.ds, nullptr, g.dss, kSet, 0.f});

  // ---- backward: dynamics, last step first ---------------------------------
  // The heads' stage deals one row of tiles; a warp is left idle unless
  // the last dynamics width has kWarps tiles (over 112 floats), and then
  // the prediction tower's weight gradients wait for the last pass.
  const bool pred_dw_early =
      (g.din[l_reward] + kTN - 1) / kTN * ((T + kTM - 1) / kTM) < kWarps;
  for (int i = K - 1; i >= 0; --i) {
    const int r0 = i * T;
    // Through the normaliser of s_{i+1}, whose gradient is complete.
    if (i + 1 < K) norm_bwd(l_state, r0, r0 + T);
    // The warps this stage leaves idle, where it leaves any, take the
    // prediction tower's weight gradients, complete since its backward.
    const Prod heads = prod(T, g.din[l_reward], bwd_term(l_reward, r0),
                            bwd_term(l_state, r0));
    Prod none = heads;
    none.M = 0;
    stage<kPrefA>(heads, bwd_out(l_reward - 1, r0), none, Out{},
                  [&](int w, int n) {
                    if (pred_dw_early && i == K - 1)
                      weight_grads(l_pred0, l_dyn0, 0, 0, w, n);
                  });
    for (int l = l_reward - 1; l > l_dyn0; --l) bwd(l, r0, T);
    // s_i feeds the prediction as is and the dynamics through
    // scale_gradient.
    stage<kPrefA>(prod(T, E, bwd_term(l_dyn0, r0)),
                  Out{at(g.ds, r0, g.dss), nullptr, g.dss, kAddScaled,
                      g.gradient_scale});
  }

  // ---- backward: representation --------------------------------------------
  norm_bwd(l_rhead, 0, 0);
  for (int l = l_rhead; l > 0; --l) bwd(l, 0, T);

  // ---- weight gradients: the block's row of partial ------------------------
  weight_grads(0, pred_dw_early ? l_pred0 : l_dyn0, l_dyn0, g.n_lin, warp,
               kWarps);
}

// grads[k] = l2_coef * w[k] + sum_g partial[g, k] (g in order, in kFinish-
// Slices runs added in order); the last block computes l2 = 0.5 * l2_coef
// * sum w^2 with a fixed-order reduction.
__global__ void __launch_bounds__(kFinishThreads)
mlp_finish_kernel(const float* __restrict__ partial, int G, int n,
                  const float* __restrict__ weights, float l2_coef,
                  float* __restrict__ grads, float* __restrict__ l2) {
  __shared__ float red[kFinishThreads];
  if (blockIdx.x + 1 < gridDim.x) {
    const int c = threadIdx.x % kFinishCols, slice = threadIdx.x / kFinishCols;
    const int k = blockIdx.x * kFinishCols + c;
    float acc = 0.f;
    if (k < n) {
      const int hi = static_cast<int>(static_cast<long>(G) * (slice + 1) /
                                      kFinishSlices);
      for (int b = static_cast<int>(static_cast<long>(G) * slice /
                                    kFinishSlices);
           b < hi; ++b)
        acc += partial[static_cast<size_t>(b) * n + k];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (slice == 0 && k < n) {
      float s = 0.f;
      for (int v = 0; v < kFinishSlices; ++v) s += red[v * kFinishCols + c];
      grads[k] = l2_coef * weights[k] + s;
    }
    return;
  }
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    s = fmaf(weights[k], weights[k], s);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) l2[0] = 0.5f * l2_coef * red[0];
}

// ---- the MLP spec with towers wider than a block's shared memory ---------
//
// mlp_cluster_kernel: a tile of kTile = 16 windows on a cluster of kc
// blocks (8, 4 or 2; `mlp_learner_plan` picks), so that the 2048 example's
// batch of 256 windows runs on 128 blocks rather than 16. It runs the tile
// pass's chain of stages as mlp_tile_kernel does, with the same products
// and row passes in the same order. Each product's columns are split over
// the cluster: block r takes a contiguous run of its 16-wide column tiles
// (of the two products of a stage, dealt as one list) with every row, and
// stages its columns' weights, a chunk of k at a time, into shared memory
// by cp.async, one copy for all its warps, kSlots chunks in flight (a
// ring). Its warps take the block's 16 x 16 warp tiles, reading the rows'
// input from the arena a few k-steps ahead of their use (tc_tile.cuh's
// prefetch) and the weights from the ring; where there are fewer tiles
// than warps, each chunk's k is split among the warps of a tile and their
// sums added in a fixed order. (Staging the rows' input as well measured
// slower on the H100.) The row passes run over the cluster's threads; a
// cluster barrier ends each stage. The tile's arena lies in the device
// scratch, which every block of the cluster reads and writes (the barrier
// orders their writes, at cluster scope, before the next stage's reads).
// The kernel leaves every linear's input rows and dz in the arena; the
// weight gradients are products over the whole batch in
// categorical_dw_kernel (each 32 x 32 tile of dW = dz^T x summed over
// every tile's rows, in a fixed order, and grads = l2_coef w + dW written
// directly), so there is no row of partial sums per block to add up. No
// float atomics, one order of every sum: a repeated launch gives the same
// bits.

constexpr int kSlots = 3;            // chunks of a pass in flight
constexpr int kSlotFloats = 4096;    // a chunk's weights
constexpr int kPassRowTiles = 8;     // row tiles of a pass
constexpr int kPassColTiles = 8;     // column tiles of a pass
constexpr int kItems = 4;            // warp tiles of a warp in a pass
constexpr int kRedFloats = kWarps * kTM * kTN;  // split-k sums
// Shared memory of a block of mlp_cluster_kernel: two blocks an SM.
constexpr int kClusterSmemFloats = kSlots * kSlotFloats + kRedFloats;

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kSlots - 1 of the thread's groups are in flight:
// after a pass has issued chunk c + kSlots - 1, chunk c has landed.
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSlots - 1) : "memory");
}

// Where copy_runs puts a run's first float in its row of shared memory:
// src's offset in floats from a 16-byte boundary, so that the row's quads
// line up with the source's (0 where the rows' stride ss is not a multiple
// of 4 floats).
__device__ __forceinline__ int run_shift(const float* src, long ss) {
  return ss % 4 ? 0
                : static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3);
}

// Copies `runs` runs of `len` floats, run r from src + r ss (device
// memory) to dst + r ds + run_shift(src, ss) (shared memory; dst 16-byte
// aligned, ds a multiple of 4 floats and at least len + 6), by the block's
// threads with cp.async: where ss is a multiple of 4 floats, the aligned
// 16-byte quads that hold each run (up to 3 floats of the neighbouring
// rows or parameters on either side, which no product reads), else a float
// at a time.
__device__ void copy_runs(float* dst, int ds, const float* src, long ss,
                          int runs, int len) {
  if (ss % 4 == 0) {
    const int sh = run_shift(src, ss);
    const int q = (sh + len + 3) / 4;
    for (int i = threadIdx.x; i < runs * q; i += kThreads) {
      const int r = i / q, c = 4 * (i % q);
      cp_float4(dst + r * ds + c, src + r * ss - sh + c);
    }
  } else {
    for (int i = threadIdx.x; i < runs * len; i += kThreads) {
      const int r = i / len, c = i % len;
      cp_float(dst + r * ds + c, src + r * ss + c);
    }
  }
}

__device__ __forceinline__ int round8(int n) { return (n + 7) / 8 * 8; }

// The block's pass over row tiles [ra, ra + rt) and column tiles [ca, ca +
// ct) of p (at most kItems x kWarps warp tiles). Both terms' k run in
// chunks of at most kc, term 0's first: chunk c's weights of the pass's
// columns go to slot c mod kSlots (as [n][k], rows of kc + 12 floats, where
// a product reads x W^T, else as [k][n], rows of ct kTN + 8; so that a
// warp's fragment loads fall in distinct banks, with room for copy_runs'
// shift). Every warp tile's sums go over the chunks in order; a warp's part
// of a chunk's k with kparts > 1.
__device__ void block_pass(const Prod& p, const Out& o, int ra, int rt,
                           int ca, int ct, float* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool kmajor = p.t0.sbk == 1;  // B(k, n) = W[n][k]
  const int cols = ct * kTN;
  const int kmax = (kmajor ? kSlotFloats / cols - 12
                           : kSlotFloats / (cols + 8)) / 8 * 8;
  const int K0 = p.t0.K, K1 = p.nterm > 1 ? p.t1.K : 0;
  const int c0 = (K0 + kmax - 1) / kmax, c1 = (K1 + kmax - 1) / kmax;
  const int kc0 = round8((K0 + c0 - 1) / c0);
  const int kc1 = c1 ? round8((K1 + c1 - 1) / c1) : 0;
  const int kc = max(kc0, kc1);
  const int bs = kmajor ? kc + 12 : cols + 8;
  const int nchunks = c0 + c1;
  const int items = rt * ct;
  const int kparts = items >= kWarps ? 1 : kWarps / items;
  const int part = items >= kWarps ? 0 : warp / items;
  const int m_lo = ra * kTM, n_lo = ca * kTN;
  auto chunk = [&](int c, const Term*& t, int& k0, int& klen) {
    t = c < c0 ? &p.t0 : &p.t1;
    const int step = c < c0 ? kc0 : kc1, K = c < c0 ? K0 : K1;
    k0 = (c < c0 ? c : c - c0) * step;
    klen = min(step, K - k0);
  };
  // Chunk c's first row of A and of the weights in device memory, and the
  // stride between the weights' rows.
  auto a_src = [&](const Term* t, int k0) {
    return t->A + static_cast<long>(m_lo) * t->sam + k0;
  };
  auto b_src = [&](const Term* t, int k0) {
    return kmajor ? t->B + static_cast<long>(n_lo) * t->sbn + k0
                  : t->B + static_cast<long>(k0) * t->sbk + n_lo;
  };
  auto b_stride = [&](const Term* t) { return kmajor ? t->sbn : t->sbk; };
  auto issue = [&](int c) {
    if (c < nchunks) {
      const Term* t;
      int k0, klen;
      chunk(c, t, k0, klen);
      const int nb = min(cols, p.N - n_lo);
      copy_runs(sm + (c % kSlots) * kSlotFloats, bs, b_src(t, k0),
                b_stride(t), kmajor ? nb : klen, kmajor ? klen : nb);
    }
    cp_commit();
  };
  float acc[kItems][1][2][4];
#pragma unroll
  for (int q = 0; q < kItems; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[q][0][j][h] = 0.f;
  // Warp tile q of this warp: it = warp + kWarps q, or, split over k, the
  // (warp mod items)-th, part warp / items of kparts.
  auto item = [&](int q) {
    return kparts > 1 ? (q == 0 && part < kparts ? warp % items : items)
                      : warp + kWarps * q;
  };
  for (int c = 0; c < kSlots - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    issue(c + kSlots - 1);
    cp_wait_ring();
    __syncthreads();
    const Term* t;
    int k0, klen;
    chunk(c, t, k0, klen);
    const float* As = a_src(t, k0);
    const float* Bs = sm + (c % kSlots) * kSlotFloats +
                      run_shift(b_src(t, k0), b_stride(t));
    const int sub = kparts > 1 ? round8((klen + kparts - 1) / kparts) : klen;
    const int kb = part * sub, ke = min(klen, kb + sub);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int it = item(q);
      if (it >= items || kb >= ke) continue;
      const int i = it / ct, j = it % ct;
      mz_tc::warp_tile<1, 2, mz_tc::chunk_steps<1, 2, true>(), true>(
          p.M - m_lo - i * kTM, p.N - n_lo - j * kTN, ke - kb,
          As + static_cast<long>(i) * kTM * t->sam + kb, t->sam, 1,
          kmajor ? Bs + j * kTN * bs + kb : Bs + kb * bs + j * kTN,
          kmajor ? 1 : bs, kmajor ? bs : 1, acc[q]);
    }
    __syncthreads();
  }
  if (kparts > 1) {  // parts 1.. leave their sums, part 0 adds them in order
    float* red = sm + kSlots * kSlotFloats;
    const int it = warp % items;
    if (part > 0 && part < kparts)
#pragma unroll
      for (int h = 0; h < 8; ++h)
        red[((part - 1) * items + it) * 256 + h * 32 + lane] =
            acc[0][0][h / 4][h % 4];
    __syncthreads();
    if (part == 0)
      for (int u = 1; u < kparts; ++u)
#pragma unroll
        for (int h = 0; h < 8; ++h)
          acc[0][0][h / 4][h % 4] +=
              red[((u - 1) * items + it) * 256 + h * 32 + lane];
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int it = item(q);
    if (it >= items || part > 0) continue;
    mz_tc::for_each(acc[q], m_lo + it / ct * kTM, n_lo + it % ct * kTN, p.M,
                    p.N, [&](int m, int n, float v) { store_out(o, m, n, v); });
  }
  if (kparts > 1) __syncthreads();  // red is free again
}

// The block's share of p: every row, column tiles [ja, jb), in passes of at
// most kPassRowTiles x kPassColTiles warp tiles and kItems a warp.
__device__ void block_product(const Prod& p, const Out& o, int ja, int jb,
                              float* sm) {
  const int row_tiles = (p.M + kTM - 1) / kTM;
  for (int ra = 0; ra < row_tiles; ra += kPassRowTiles) {
    const int rt = min(kPassRowTiles, row_tiles - ra);
    const int cpp = min(kPassColTiles, kItems * kWarps / rt);
    for (int ca = ja; ca < jb; ca += cpp)
      block_pass(p, o, ra, rt, ca, min(cpp, jb - ca), sm);
  }
}

// A stage of the cluster pass: the column tiles of p1 and then of p2 (none
// when p2.M is 0), dealt in contiguous runs to the cluster's blocks, then
// the cluster's barrier.
__device__ void cluster_stage(const Prod& p1, const Out& o1, const Prod& p2,
                              const Out& o2, float* sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int kc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n1 = (p1.N + kTN - 1) / kTN;
  const int n = n1 + (p2.M > 0 ? (p2.N + kTN - 1) / kTN : 0);
  const int lo = rank * n / kc, hi = (rank + 1) * n / kc;
  if (lo < min(hi, n1)) block_product(p1, o1, lo, min(hi, n1), sm);
  if (max(lo, n1) < hi) block_product(p2, o2, max(lo, n1) - n1, hi - n1, sm);
  cluster.sync();
}

__device__ __forceinline__ void cluster_stage(const Prod& p1, const Out& o1,
                                              float* sm) {
  Prod none = p1;
  none.M = 0;
  cluster_stage(p1, o1, none, o1, sm);
}

__global__ void __launch_bounds__(kThreads, 2)
mlp_cluster_kernel(const float* __restrict__ raw,
                   const float* __restrict__ coef,
                   const float* __restrict__ weights,
                   float* __restrict__ arena, float* __restrict__ met,
                   const __grid_constant__ MlpArgs g) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int kc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = static_cast<int>(blockIdx.x) / kc;
  const int cw = rank * kWarps + (threadIdx.x >> 5), cws = kc * kWarps;
  const int ct = rank * kThreads + threadIdx.x, cts = kc * kThreads;
  extern __shared__ __align__(16) float smem[];
  const float* Ws = weights;
  float* base = arena + static_cast<long>(tile) * g.arena_floats;
  const int w0 = tile * kTile;
  const int T = kTile, K = g.K, R = K * T, E = g.E, A = g.A, S41 = g.S41;
  const size_t ld = static_cast<size_t>(g.ld);
  const int l_rhead = g.n_repr, l_pred0 = l_rhead + 1;
  const int l_value = l_pred0 + g.n_pred, l_policy = l_value + 1;
  const int l_dyn0 = l_policy + 1, l_reward = l_dyn0 + g.n_dyn;
  const int l_state = l_reward + 1;
  float* rt = base + g.rt;
  auto tile_raw = [&](int first, int i, int t) {
    return rt[(first + i) * T + t];
  };
  const int q_pi = 3 * K, q_mask = q_pi + K * A, q_coef = q_mask + K;
  auto cm_of = [&](int i, int t) {
    return tile_raw(q_coef, 0, t) * tile_raw(q_mask, i, t);
  };
  auto at = [&](long off, int row, int stride) {
    return base + off + static_cast<long>(row) * stride;
  };
  auto fwd_term = [&](int l, int r0) {
    return Term{at(g.x[l], r0, g.xs[l]), g.xs[l], 1, Ws + g.off[l], 1,
                g.din[l], g.din[l]};
  };
  auto bwd_term = [&](int l, int r0) {
    return Term{at(g.dz[l], r0, g.ys[l]), g.ys[l], 1, Ws + g.off[l],
                g.din[l], 1, g.dout[l]};
  };
  auto fwd_out = [&](int l, int r0, bool act) {
    return Out{at(g.y[l], r0, g.ys[l]), Ws + g.off[l] + g.din[l] * g.dout[l],
               g.ys[l], act ? kElu : kLinear, 0.f};
  };
  auto bwd_out = [&](int lp, int r0) {
    return Out{at(g.dz[lp], r0, g.ys[lp]), at(g.y[lp], r0, g.ys[lp]),
               g.ys[lp], kEluGrad, 0.f};
  };
  auto fwd = [&](int l, int r0, int M, bool act) {
    cluster_stage(prod(M, g.dout[l], fwd_term(l, r0)), fwd_out(l, r0, act),
                  smem);
  };
  auto bwd = [&](int l, int r0, int M) {
    cluster_stage(prod(M, g.din[l], bwd_term(l, r0)), bwd_out(l - 1, r0),
                  smem);
  };
  const int lane = threadIdx.x & 31;
  const int nl = threadIdx.x % kNormLanes;
  const unsigned nmask = ((1u << kNormLanes) - 1) << (lane & -kNormLanes);
  auto next_state = [&](int l, int src, int i) {
    for (int t = ct / kNormLanes; t < T; t += cts / kNormLanes) {
      float* s = at(g.sa, i * T + t, g.sas);
      minmax<kNormLanes>(at(g.y[l], src + t, g.ys[l]), s, E, nl, nmask);
      const int a = static_cast<int>(tile_raw(0, i, t));
      for (int j = nl; j < A; j += kNormLanes) s[E + j] = j == a ? 1.f : 0.f;
    }
    cluster.sync();
  };
  auto norm_bwd = [&](int l, int r0, int ds0) {
    for (int t = ct / kNormLanes; t < T; t += cts / kNormLanes)
      norm_bwd_row<kNormLanes>(at(g.y[l], r0 + t, g.ys[l]),
                               at(g.ds, ds0 + t, g.dss),
                               at(g.dz[l], r0 + t, g.ys[l]), E, nl, nmask);
    cluster.sync();
  };
  float* ce = base + g.ce;
  // ---- cluster forward: the start observations and the tile's raw rows
  // (0 past the batch) into the arena
  auto copy_raw = [&](float* dst, const float* src, int t) {
    *dst = w0 + t >= g.B ? 0.f : src[w0 + t];
  };
  for (int i = ct; i < T * g.O; i += cts)
    copy_raw(base + g.x0 + (i % T) * g.x0s + i / T,
             raw + (g.r_obs + i / T) * ld, i % T);
  for (int i = ct; i < q_coef * T; i += cts) {
    const int q = i / T;
    const int row = q < K        ? g.r_action + q
                    : q < 2 * K  ? g.r_reward + q - K
                    : q < q_pi   ? g.r_rn + q - 2 * K
                    : q < q_mask ? g.r_pi + q - q_pi
                                 : g.r_mask + q - q_mask;
    copy_raw(rt + i, raw + row * ld, i % T);
  }
  for (int t = ct; t < T; t += cts) copy_raw(rt + q_coef * T + t, coef, t);
  {  // the last step's next state feeds nothing: its gradient is 0
    float* d = at(g.dz[l_state], (K - 1) * T, g.ys[l_state]);
    for (int i = ct; i < T * g.ys[l_state]; i += cts) d[i] = 0.f;
  }
  cluster.sync();
  for (int l = 0; l <= l_rhead; ++l) fwd(l, 0, T, l < l_rhead);
  next_state(l_rhead, 0, 0);
  for (int i = 0; i < K; ++i) {
    const int r0 = i * T;
    for (int l = l_dyn0; l < l_reward; ++l) fwd(l, r0, T, true);
    cluster_stage(prod(T, S41, fwd_term(l_reward, r0)),
                  fwd_out(l_reward, r0, false),
                  prod(T, E, fwd_term(l_state, r0)),
                  fwd_out(l_state, r0, false), smem);
    if (i + 1 < K) next_state(l_state, r0, i + 1);
  }
  for (int l = l_pred0; l < l_value; ++l) fwd(l, 0, R, true);
  cluster_stage(prod(R, S41, fwd_term(l_value, 0)),
                fwd_out(l_value, 0, false),
                prod(R, A, fwd_term(l_policy, 0)),
                fwd_out(l_policy, 0, false), smem);
  // v0 = h^-1 of the first step's expected value, a warp a window, summed
  // as mlp_tile_kernel sums it.
  for (int t = cw; t < T; t += cws) {
    const float* z = at(g.y[l_value], t, g.ys[l_value]);
    float m = -INFINITY;
    for (int j = lane; j < S41; j += 32) m = fmaxf(m, z[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < S41; j += 32) s += expf(z[j] - m);
    const float log_s = logf(warp_sum(s));
    float ev = 0.f;
    for (int j = lane; j < S41; j += 32)
      ev += expf((z[j] - m) - log_s) * static_cast<float>(j - g.support);
    ev = warp_sum(ev);
    if (lane == 0) ce[3 * R + t] = inv_value_transform(ev);
  }
  cluster.sync();
  // The three heads' cross-entropies and dz over every step.
  for (int q = ct; q < 3 * R; q += cts) {
    const int r = q % R, i = r / T, t = r % T;
    if (q >= 2 * R) {
      ce[q] = softmax_ce_grad(at(g.y[l_reward], r, g.ys[l_reward]), S41,
                              two_hot(tile_raw(K, i, t), g.support),
                              cm_of(i, t));
    } else if (q < R) {
      ce[q] = softmax_ce_grad(at(g.y[l_value], r, g.ys[l_value]), S41,
                              two_hot(tile_raw(2 * K, i, t), g.support),
                              cm_of(i, t));
    } else {
      ce[q] = softmax_ce_grad(
          at(g.y[l_policy], r, g.ys[l_policy]), A,
          [&](int j) { return tile_raw(q_pi + i * A, j, t); }, cm_of(i, t));
    }
  }
  cluster.sync();
  for (int t = ct; t < T && w0 + t < g.B; t += cts) {
    float v_sum = 0.f, p_sum = 0.f, r_sum = 0.f;
    for (int i = 0; i < K; ++i) {
      const float mask = tile_raw(q_mask, i, t);
      v_sum += mask * ce[i * T + t];
      p_sum += mask * ce[R + i * T + t];
      r_sum += mask * ce[2 * R + i * T + t];
    }
    const int w = w0 + t;
    met[w] = v_sum;
    met[g.B + w] = p_sum;
    met[2 * g.B + w] = r_sum;
    met[3 * g.B + w] = ce[3 * R + t];
  }

  // ---- cluster backward: prediction over every step, then the dynamics
  // from the last step, then the representation
  cluster_stage(prod(R, g.din[l_value], bwd_term(l_value, 0),
                     bwd_term(l_policy, 0)),
                bwd_out(l_value - 1, 0), smem);
  for (int l = l_value - 1; l > l_pred0; --l) bwd(l, 0, R);
  cluster_stage(prod(R, E, bwd_term(l_pred0, 0)),
                Out{base + g.ds, nullptr, g.dss, kSet, 0.f}, smem);
  for (int i = K - 1; i >= 0; --i) {
    const int r0 = i * T;
    if (i + 1 < K) norm_bwd(l_state, r0, r0 + T);
    cluster_stage(prod(T, g.din[l_reward], bwd_term(l_reward, r0),
                       bwd_term(l_state, r0)),
                  bwd_out(l_reward - 1, r0), smem);
    for (int l = l_reward - 1; l > l_dyn0; --l) bwd(l, r0, T);
    cluster_stage(prod(T, E, bwd_term(l_dyn0, r0)),
                  Out{at(g.ds, r0, g.dss), nullptr, g.dss, kAddScaled,
                      g.gradient_scale},
                  smem);
  }
  norm_bwd(l_rhead, 0, 0);
  for (int l = l_rhead; l > 0; --l) bwd(l, 0, T);
}

// The linear table and a block's arena; false when the shapes do not fit
// the kernel. models/fused_learner.py `mlp_learner_floats` repeats the
// arena's arithmetic for the launch plan (which the CPU tests size without
// this library); tests/test_torch_fused_learner_kernel.py
// `test_plan_agrees_with_the_kernel` ties the two copies together.
bool mlp_layout(MlpArgs* g, int O, int E, int A, int S41, int K, int n_repr,
                const int* repr_w, int n_pred, const int* pred_w, int n_dyn,
                const int* dyn_w) {
  if (O < 1 || E < 1 || A < 1 || S41 < 1 || K < 1 || n_repr < 0 ||
      n_repr > kMaxLayers || n_pred < 1 || n_pred > kMaxLayers ||
      n_dyn < 1 || n_dyn > kMaxLayers)
    return false;
  for (int l = 0; l < n_repr; ++l)
    if (repr_w[l] < 1) return false;
  for (int l = 0; l < n_pred; ++l)
    if (pred_w[l] < 1) return false;
  for (int l = 0; l < n_dyn; ++l)
    if (dyn_w[l] < 1) return false;
  g->O = O;
  g->E = E;
  g->A = A;
  g->S41 = S41;
  g->K = K;
  g->n_repr = n_repr;
  g->n_pred = n_pred;
  g->n_dyn = n_dyn;
  const int T = kTile, R = K * T;
  long cur = 0;
  auto take = [&](long floats) {
    const long at = cur;
    cur += floats;
    return at;
  };
  g->x0s = padded(O);
  g->x0 = take(static_cast<long>(T) * g->x0s);
  g->rt = take(static_cast<long>(4 * K + K * A + 1) * T);
  g->sas = padded(E + A);
  g->sa = take(static_cast<long>(R) * g->sas);
  g->dss = padded(E);
  g->ds = take(static_cast<long>(R) * g->dss);
  int n = 0, off = 0;
  long x = g->x0;
  int xs = g->x0s, in = O;
  auto add = [&](int out, int rows, bool softmax) {
    g->off[n] = off;
    g->din[n] = in;
    g->dout[n] = out;
    off += in * out + out;
    g->rows[n] = rows;
    g->x[n] = x;
    g->xs[n] = xs;
    g->ys[n] = padded(out);
    g->y[n] = take(static_cast<long>(rows) * g->ys[n]);
    g->dz[n] = softmax ? g->y[n] : take(static_cast<long>(rows) * g->ys[n]);
    ++n;
  };
  auto hidden = [&](int out, int rows) {
    add(out, rows, false);
    x = g->y[n - 1];
    xs = g->ys[n - 1];
    in = out;
  };
  for (int l = 0; l < n_repr; ++l) hidden(repr_w[l], T);
  add(E, T, false);
  x = g->sa;  // the prediction reads the first E columns
  xs = g->sas;
  in = E;
  for (int l = 0; l < n_pred; ++l) hidden(pred_w[l], R);
  add(S41, R, true);
  add(A, R, true);
  x = g->sa;
  xs = g->sas;
  in = E + A;
  for (int l = 0; l < n_dyn; ++l) hidden(dyn_w[l], R);
  add(S41, R, true);
  add(E, R, false);
  g->n_lin = n;
  g->ce = take(3L * R + T);
  g->arena_floats = (cur + 3) / 4 * 4;
  g->n_weights = off;
  g->smem_weights = (off + 3) / 4 * 4;
  g->tile0[0] = g->col0[0] = 0;
  for (int l = 0; l < n; ++l) {
    g->tile0[l + 1] = g->tile0[l] + (g->dout[l] + kTM - 1) / kTM *
                                        ((g->din[l] + kTN - 1) / kTN);
    g->col0[l + 1] = g->col0[l] + g->dout[l];
  }
  return true;
}

using MlpKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, float*, const MlpArgs);

// The instance of a plan with staged weights: the arena in shared memory
// beside them, or in the scratch.
MlpKernel mlp_kernel(bool smem_arena) {
  return smem_arena ? mlp_tile_kernel<true> : mlp_tile_kernel<false>;
}

// ---- the categorical LearnerSpec: two kernels --------------------------
//
// Replaces the same TPU kernel with the categorical spec
// (`extract_categorical_learner_spec`, muax_tpu/models/fused_learner.py:180):
// LayerNorm-tanh first layers (backward at :476-485) and linear [vmin, vmax]
// two-hot targets (:371-381), v0 the linear expectation (:523-525). At the
// widths of bench.py's categorical_training (three towers of (256, 256,
// 256), about 490 K weights) neither the weights nor a block's gradient sums
// fit in shared memory, so the work is organised around products.
//
// categorical_tile_kernel: a block owns kCatTile windows and keeps every
// activation of their forward pass in a device-memory scratch of its own;
// each layer runs as one [rows, in] x [in, out] product on the tensor cores
// (tc_tile.cuh, 3xTF32; rows: the tile's windows for the representation and
// for each dynamics step, all K steps at once for the prediction, which only
// the dynamics chain feeds). The backward runs the prediction over all
// steps, then the dynamics from the last step back, then the
// representation, and leaves each layer's dZ (and, for a LayerNorm layer,
// dU and x-hat) in the scratch.
//
// categorical_dw_kernel: the weight-gradient pass. The TPU kernel sums dW
// in VMEM across its sequential grid (:598-614); here the blocks of the
// first kernel run in parallel, so a second kernel reads their scratch. Each
// of its blocks owns one 32 x 32 tile of one dW = dZ^T X (its eight warps
// take a half of the tile's rows and a quarter of the first kernel's blocks
// each, in order, and the quarters are added in order), or 8 columns of one
// layer's bias and LayerNorm gradients (32 slices of the blocks, added in
// order), or the l2 sum; it writes grads = l2_coef w + dW directly. No float
// atomics, every sum in a fixed order: two launches on the same inputs give
// bit-identical gradients.
//
// What bounds it: per window about 1.84 M multiply-adds forward and twice
// that backward at K = 5, so 1024 windows are about 11.3 GFLOP: 0.17 ms at
// the f32 FMA peak, 0.069 ms at the TF32 tensor-core peak taken three times
// (3xTF32). kCatTile = 8 gives 128 blocks at batch 1024, one per SM, and
// 16 warps a block keep twice the loads of eight in flight, each on a
// 16 x 16 tile of a product.

constexpr int kCatTile = 8;
constexpr int kCatThreads = 512;  // categorical_tile_kernel
constexpr int kCatWarps = kCatThreads / 32;
constexpr int kDwThreads = 256;   // categorical_dw_kernel
constexpr int kDwWarps = kDwThreads / 32;

struct CatTower {
  int n, in, n_heads;
  int width[kMaxLayers], kind[kMaxLayers], w_off[kMaxLayers];
  int head_out[2], head_off[2];
  // Scratch offsets (floats, from the block's base): the tower's input rows,
  // per hidden layer its activations, LayerNorm x-hat and 1/sigma, dZ and
  // dU (the gradient at the LayerNorm's output), and per head its outputs
  // and dZ.
  long x0;
  long y[kMaxLayers], xh[kMaxLayers], inv[kMaxLayers], dz[kMaxLayers],
      du[kMaxLayers];
  long hz[2], dh[2];
};

struct CatArgs {
  int B, ld, O, E, A, bins, K;
  float vmin, vmax, bin_step, gradient_scale;
  int r_obs, r_action, r_reward, r_rn, r_pi, r_mask;
  int n_weights;
  long block_floats;
  CatTower repr, pred, dyn;
  long ds, dsd, dx0, dx1, ce;  // scratch: gradients into s, temporaries, CEs
};

// One linear of the towers as the weight-gradient pass reads it: the
// scratch offsets of its input rows X and of dZ (and, for a LayerNorm
// layer, x-hat and dU; -1 otherwise), its shape, the rows each block of the
// first kernel holds, where W [out, in] starts in the flat parameters
// (b [out] follows, then the LayerNorm's scale and offset), and the floats
// a row of X and of dZ take (in and out where the rows are packed).
struct DwLinear {
  long x, dz, xh, du;
  int in, out, rows, w_off, ldx, ldz;
};

constexpr int kDwTile = 32;   // dW tiles are kDwTile x kDwTile
constexpr int kColChunk = 8;  // columns of a bias-gradient block

struct DwArgs {
  int n_lin, G, n_weights;
  long block_floats;
  float l2_coef;
  DwLinear lin[kMaxLin];
  // Blocks before linear l's dW tiles, and before its column-sum blocks
  // (after every dW tile); the last block sums l2.
  int tile0[kMaxLin + 1], col0[kMaxLin + 1];
};

// Linear two-hot over bins j: vmin + j * step (ops/support.py
// scalar_to_two_hot, the kernel's :371-381).
struct LinearTwoHot {
  float low, high, ph;
  __device__ float operator()(int j) const {
    const float bin = static_cast<float>(j);
    return (bin == low ? 1.f - ph : 0.f) + (bin == high ? ph : 0.f);
  }
};

__device__ LinearTwoHot linear_two_hot(float x, const CatArgs& g) {
  const float pos = (fminf(fmaxf(x, g.vmin), g.vmax) - g.vmin) / g.bin_step;
  const float low = floorf(pos);
  return LinearTwoHot{low, fminf(low + 1.f, static_cast<float>(g.bins - 1)),
                      pos - low};
}

// The forward of a tower's hidden layers on rows [r0, r0 + rows).
__device__ void cat_tower_fwd(const CatTower& tw, const float* Wt,
                              float* base, int r0, int rows, int warp,
                              int lane) {
  const float* x = base + tw.x0 + static_cast<long>(r0) * tw.in;
  int in = tw.in;
  for (int l = 0; l < tw.n; ++l) {
    const int out = tw.width[l];
    const float* W = Wt + tw.w_off[l];
    const float* b = W + out * in;
    float* y = base + tw.y[l] + static_cast<long>(r0) * out;
    mz_tc::gemm(rows, out, in, x, in, 1, W, 1, in, y, out, 1, b, false);
    __syncthreads();
    for (int r = warp; r < rows; r += kCatWarps) {
      float* yr = y + static_cast<long>(r) * out;
      if (tw.kind[l] == 0) {
        for (int j = lane; j < out; j += 32) yr[j] = elu(yr[j]);
      } else {
        float sum = 0.f;
        for (int j = lane; j < out; j += 32) sum += yr[j];
        const float mean = warp_sum(sum) / static_cast<float>(out);
        float var = 0.f;
        for (int j = lane; j < out; j += 32) {
          const float d = yr[j] - mean;
          var += d * d;
        }
        const float inv =
            rsqrtf(warp_sum(var) / static_cast<float>(out) + 1e-5f);
        float* xh = base + tw.xh[l] + static_cast<long>(r0 + r) * out;
        const float* scale = b + out;
        const float* offset = b + 2 * out;
        for (int j = lane; j < out; j += 32) {
          xh[j] = (yr[j] - mean) * inv;
          yr[j] = tanhf(xh[j] * scale[j] + offset[j]);
        }
        if (lane == 0) base[tw.inv[l] + r0 + r] = inv;
      }
      __syncwarp();
    }
    __syncthreads();
    x = y;
    in = out;
  }
}

// A head of a tower on rows [r0, r0 + rows): hz = last hidden @ W^T + b.
__device__ void cat_head_fwd(const CatTower& tw, int h, const float* Wt,
                             float* base, int r0, int rows) {
  const int in = tw.width[tw.n - 1], out = tw.head_out[h];
  const float* x = base + tw.y[tw.n - 1] + static_cast<long>(r0) * in;
  const float* W = Wt + tw.head_off[h];
  mz_tc::gemm(rows, out, in, x, in, 1, W, 1, in,
              base + tw.hz[h] + static_cast<long>(r0) * out, out, 1,
              W + out * in, false);
  __syncthreads();
}

// dy (rows [r0, r0 + rows) of the gradient at a head's input) from the
// heads' dZ: sum_h dh_h @ W_h.
__device__ void cat_heads_bwd(const CatTower& tw, const float* Wt,
                              float* base, int r0, int rows, float* dy) {
  const int in = tw.width[tw.n - 1];
  for (int h = 0; h < tw.n_heads; ++h) {
    const int out = tw.head_out[h];
    mz_tc::gemm(rows, in, out, base + tw.dh[h] + static_cast<long>(r0) * out,
                out, 1, Wt + tw.head_off[h], in, 1, dy, in, 1, nullptr,
                h > 0);
    __syncthreads();
  }
}

// The backward of a tower's hidden layers on rows [r0, r0 + rows), from dy
// (the gradient at the last hidden activation, [rows, width]); keeps each
// layer's dZ (and dU) and writes the gradient at the tower's first `nx`
// inputs to dx_out [rows, nx] (nothing when nx is 0). tmp holds [rows,
// widest layer].
__device__ void cat_tower_bwd(const CatTower& tw, const float* Wt,
                              float* base, int r0, int rows, float* dy,
                              float* tmp, float* dx_out, int nx, int warp,
                              int lane) {
  for (int l = tw.n - 1; l >= 0; --l) {
    const int out = tw.width[l];
    const int in = l > 0 ? tw.width[l - 1] : tw.in;
    const float* W = Wt + tw.w_off[l];
    const float* scale = W + out * in + out;
    const float* y = base + tw.y[l] + static_cast<long>(r0) * out;
    float* dz = base + tw.dz[l] + static_cast<long>(r0) * out;
    for (int r = warp; r < rows; r += kCatWarps) {
      const float* yr = y + static_cast<long>(r) * out;
      const float* dyr = dy + static_cast<long>(r) * out;
      float* dzr = dz + static_cast<long>(r) * out;
      if (tw.kind[l] == 0) {
        for (int j = lane; j < out; j += 32)
          dzr[j] = dyr[j] * (yr[j] > 0.f ? 1.f : yr[j] + 1.f);
      } else {
        const long row = static_cast<long>(r0 + r) * out;
        const float* xh = base + tw.xh[l] + row;
        float* du = base + tw.du[l] + row;
        float m1 = 0.f, m2 = 0.f;
        for (int j = lane; j < out; j += 32) {
          du[j] = dyr[j] * (1.f - yr[j] * yr[j]);
          const float dxhat = du[j] * scale[j];
          m1 += dxhat;
          m2 += dxhat * xh[j];
        }
        m1 = warp_sum(m1) / static_cast<float>(out);
        m2 = warp_sum(m2) / static_cast<float>(out);
        const float inv = base[tw.inv[l] + r0 + r];
        for (int j = lane; j < out; j += 32)
          dzr[j] = inv * (du[j] * scale[j] - m1 - xh[j] * m2);
      }
      __syncwarp();
    }
    __syncthreads();
    if (l > 0) {
      mz_tc::gemm(rows, in, out, dz, out, 1, W, in, 1, tmp, in, 1, nullptr,
                  false);
      __syncthreads();
      float* t = dy;
      dy = tmp;
      tmp = t;
    } else if (nx > 0) {
      mz_tc::gemm(rows, nx, out, dz, out, 1, W, in, 1, dx_out, nx, 1,
                  nullptr, false);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kCatThreads, 1)
categorical_tile_kernel(const float* __restrict__ raw,
                        const float* __restrict__ coef,
                        const float* __restrict__ weights,
                        float* __restrict__ scratch, float* __restrict__ met,
                        const CatArgs g) {
  constexpr int T = kCatTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * T;
  const int E = g.E, A = g.A, bins = g.bins, K = g.K, KT = K * T;
  float* base = scratch + blockIdx.x * g.block_floats;
  const size_t ld = static_cast<size_t>(g.ld);
  // Raw row `row` of the tile's window t; 0 past the batch.
  auto rawv = [&](int row, int t) {
    const int w = w0 + t;
    return w < g.B ? raw[row * ld + w] : 0.f;
  };
  const CatTower& rp = g.repr;
  const CatTower& pp = g.pred;
  const CatTower& dp = g.dyn;
  float* S = base + pp.x0;   // [K*T, E]: s_0 .. s_{K-1}
  float* SA = base + dp.x0;  // [K*T, E + A]
  float* ce = base + g.ce;   // [3, K*T] value, policy, reward CE; [T] v0

  // ---- forward ------------------------------------------------------------
  for (int i = threadIdx.x; i < T * g.O; i += blockDim.x)
    base[rp.x0 + i] = rawv(g.r_obs + i % g.O, i / g.O);
  __syncthreads();
  cat_tower_fwd(rp, weights, base, 0, T, warp, lane);
  cat_head_fwd(rp, 0, weights, base, 0, T);
  for (int r = warp; r < T; r += kCatWarps)
    minmax(base + rp.hz[0] + r * E, S + r * E, E, lane);
  __syncthreads();
  for (int i = 0; i < K; ++i) {
    const int r0 = i * T;
    for (int r = warp; r < T; r += kCatWarps) {
      const int a = static_cast<int>(rawv(g.r_action + i, r));
      float* x = SA + static_cast<long>(r0 + r) * (E + A);
      const float* s = S + static_cast<long>(r0 + r) * E;
      for (int j = lane; j < E + A; j += 32)
        x[j] = j < E ? s[j] : (j - E == a ? 1.f : 0.f);
    }
    __syncthreads();
    cat_tower_fwd(dp, weights, base, r0, T, warp, lane);
    cat_head_fwd(dp, 0, weights, base, r0, T);
    cat_head_fwd(dp, 1, weights, base, r0, T);
    for (int r = warp; r < T; r += kCatWarps) {
      float* rz = base + dp.hz[0] + static_cast<long>(r0 + r) * bins;
      const float c =
          softmax_ce(rz, bins, linear_two_hot(rawv(g.r_reward + i, r), g),
                     lane);
      if (lane == 0) ce[2 * KT + r0 + r] = c;
      if (i + 1 < K)
        minmax(base + dp.hz[1] + static_cast<long>(r0 + r) * E,
               S + static_cast<long>(r0 + T + r) * E, E, lane);
    }
    __syncthreads();
  }
  cat_tower_fwd(pp, weights, base, 0, KT, warp, lane);
  cat_head_fwd(pp, 0, weights, base, 0, KT);
  cat_head_fwd(pp, 1, weights, base, 0, KT);
  for (int r = warp; r < KT; r += kCatWarps) {
    const int i = r / T, t = r % T;
    float* pz = base + pp.hz[0] + static_cast<long>(r) * A;
    float* vz = base + pp.hz[1] + static_cast<long>(r) * bins;
    const int pi_row = g.r_pi + i * A;
    const float cp =
        softmax_ce(pz, A, [&](int j) { return rawv(pi_row + j, t); }, lane);
    const float cv =
        softmax_ce(vz, bins, linear_two_hot(rawv(g.r_rn + i, t), g), lane);
    float v0 = 0.f;
    if (i == 0) {
      for (int j = lane; j < bins; j += 32)
        v0 += vz[j] * (g.vmin + static_cast<float>(j) * g.bin_step);
      v0 = warp_sum(v0);
    }
    if (lane == 0) {
      ce[r] = cv;
      ce[KT + r] = cp;
      if (i == 0) ce[3 * KT + t] = v0;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T && w0 + t < g.B; t += blockDim.x) {
    float v_sum = 0.f, p_sum = 0.f, r_sum = 0.f;
    for (int i = 0; i < K; ++i) {
      const float mask = rawv(g.r_mask + i, t);
      v_sum += mask * ce[i * T + t];
      p_sum += mask * ce[KT + i * T + t];
      r_sum += mask * ce[2 * KT + i * T + t];
    }
    const int w = w0 + t;
    met[w] = v_sum;
    met[g.B + w] = p_sum;
    met[2 * g.B + w] = r_sum;
    met[3 * g.B + w] = ce[3 * KT + t];
  }

  // ---- backward: prediction over every step --------------------------------
  for (int r = warp; r < KT; r += kCatWarps) {
    const int i = r / T, t = r % T;
    const float cm = (w0 + t < g.B ? coef[w0 + t] : 0.f) *
                     rawv(g.r_mask + i, t);
    const float* pz = base + pp.hz[0] + static_cast<long>(r) * A;
    const float* vz = base + pp.hz[1] + static_cast<long>(r) * bins;
    float* dpz = base + pp.dh[0] + static_cast<long>(r) * A;
    float* dvz = base + pp.dh[1] + static_cast<long>(r) * bins;
    const int pi_row = g.r_pi + i * A;
    for (int j = lane; j < A; j += 32)
      dpz[j] = cm * (pz[j] - rawv(pi_row + j, t));
    const LinearTwoHot vt = linear_two_hot(rawv(g.r_rn + i, t), g);
    for (int j = lane; j < bins; j += 32) dvz[j] = cm * (vz[j] - vt(j));
  }
  __syncthreads();
  float* dx0 = base + g.dx0;
  float* dx1 = base + g.dx1;
  float* dspred = base + g.dsd + T * E;  // [K*T, E]
  cat_heads_bwd(pp, weights, base, 0, KT, dx0);
  cat_tower_bwd(pp, weights, base, 0, KT, dx0, dx1, dspred, E, warp, lane);

  // ---- backward: dynamics, last step first ---------------------------------
  float* ds = base + g.ds;    // [T, E]: the gradient into s_{i+1}
  float* dsd = base + g.dsd;  // [T, E]: into s_i through the dynamics
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) ds[i] = 0.f;
  __syncthreads();
  for (int i = K - 1; i >= 0; --i) {
    const int r0 = i * T;
    for (int r = warp; r < T; r += kCatWarps) {
      const float cm = (w0 + r < g.B ? coef[w0 + r] : 0.f) *
                       rawv(g.r_mask + i, r);
      minmax_bwd(base + dp.hz[1] + static_cast<long>(r0 + r) * E, ds + r * E,
                 base + dp.dh[1] + static_cast<long>(r0 + r) * E, E, lane);
      const float* rz = base + dp.hz[0] + static_cast<long>(r0 + r) * bins;
      float* drz = base + dp.dh[0] + static_cast<long>(r0 + r) * bins;
      const LinearTwoHot rt = linear_two_hot(rawv(g.r_reward + i, r), g);
      for (int j = lane; j < bins; j += 32) drz[j] = cm * (rz[j] - rt(j));
      __syncwarp();
    }
    __syncthreads();
    cat_heads_bwd(dp, weights, base, r0, T, dx0);
    cat_tower_bwd(dp, weights, base, r0, T, dx0, dx1, dsd, E, warp, lane);
    // s_i feeds the prediction as is and the dynamics through
    // scale_gradient.
    for (int j = threadIdx.x; j < T * E; j += blockDim.x)
      ds[j] = dspred[r0 * E + j] + g.gradient_scale * dsd[j];
    __syncthreads();
  }

  // ---- backward: representation --------------------------------------------
  for (int r = warp; r < T; r += kCatWarps)
    minmax_bwd(base + rp.hz[0] + r * E, ds + r * E, base + rp.dh[0] + r * E,
               E, lane);
  __syncthreads();
  cat_heads_bwd(rp, weights, base, 0, T, dx0);
  cat_tower_bwd(rp, weights, base, 0, T, dx0, dx1, nullptr, 0, warp, lane);
}

// The blocks of the first kernel that warp (or row slice) `part` of
// `parts` sums over: an even split, in order.
__device__ __forceinline__ int block_lo(int G, int part, int parts) {
  return static_cast<int>(static_cast<long>(G) * part / parts);
}

// One kDwTile x kDwTile tile of dW = dZ^T X of linear L: warp w sums rows
// [16 (w % 2), 16 (w % 2) + 16) of it over the first kernel's blocks of
// slice w / 2 (a quarter of them, in order), the block adds the four
// slices in order, and grads = l2_coef * w + dW.
__device__ void dw_tile(const DwArgs& g, const DwLinear& L, int m0, int n0,
                        const float* scratch, const float* weights,
                        float* grads, float* red) {
  constexpr int kSlices = kDwWarps / 2;
  const int warp = threadIdx.x >> 5;
  const int half = warp % 2, slice = warp / 2;
  float acc[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[0][j][h] = 0.f;
  const int out = L.out, in = L.in;
  const int mh = m0 + 16 * half;  // this warp's first row of the tile
  if (mh < out) {
    const int hi = block_lo(g.G, slice + 1, kSlices);
    for (int b = block_lo(g.G, slice, kSlices); b < hi; ++b) {
      const float* dz = scratch + b * g.block_floats + L.dz;  // [rows, out]
      const float* x = scratch + b * g.block_floats + L.x;    // [rows, in]
      mz_tc::warp_tile<1, 4, mz_tc::chunk_steps<1, 4, true>(), true>(
          out - mh, in - n0, L.rows, dz + mh, 1, L.ldz, x + n0, L.ldx, 1,
          acc);
    }
  }
  float* mine = red + warp * 16 * kDwTile;
  mz_tc::for_each(acc, 0, 0, 16, kDwTile,
                  [&](int m, int n, float v) { mine[m * kDwTile + n] = v; });
  __syncthreads();
  for (int e = threadIdx.x; e < kDwTile * kDwTile; e += blockDim.x) {
    const int m = e / kDwTile, n = e % kDwTile;
    const int o = m0 + m, i = n0 + n;
    if (o >= out || i >= in) continue;
    float s = 0.f;
    for (int v = 0; v < kSlices; ++v)
      s += red[(2 * v + m / 16) * 16 * kDwTile + (m % 16) * kDwTile + n];
    const long k = L.w_off + static_cast<long>(o) * in + i;
    grads[k] = g.l2_coef * weights[k] + s;
  }
}

// The bias gradient (and, for a LayerNorm layer, its scale's and offset's)
// of columns [c0, c0 + kColChunk) of linear L: thread (slice, column) sums
// a slice of the first kernel's blocks in order, then the slices are added
// in order.
__device__ void dw_columns(const DwArgs& g, const DwLinear& L, int c0,
                           const float* scratch, const float* weights,
                           float* grads, float* red) {
  constexpr int kSlices = kDwThreads / kColChunk;
  const int slice = threadIdx.x / kColChunk, c = threadIdx.x % kColChunk;
  const int o = c0 + c, out = L.out;
  const bool ln = L.du >= 0;
  float db = 0.f, dscale = 0.f, doffset = 0.f;
  if (o < out) {
    const int hi = block_lo(g.G, slice + 1, kSlices);
    for (int b = block_lo(g.G, slice, kSlices); b < hi; ++b) {
      const float* blk = scratch + b * g.block_floats + o;
#pragma unroll 8
      for (int r = 0; r < L.rows; ++r) {
        const long at = static_cast<long>(r) * out;
        db += blk[L.dz + static_cast<long>(r) * L.ldz];
        if (ln) {
          const float du = blk[L.du + at];
          dscale += du * blk[L.xh + at];
          doffset += du;
        }
      }
    }
  }
  red[threadIdx.x] = db;
  red[kDwThreads + threadIdx.x] = dscale;
  red[2 * kDwThreads + threadIdx.x] = doffset;
  __syncthreads();
  if (slice != 0 || o >= out) return;
  for (int q = 0; q < (ln ? 3 : 1); ++q) {
    float s = 0.f;
    for (int v = 0; v < kSlices; ++v)
      s += red[q * kDwThreads + v * kColChunk + c];
    const long k = L.w_off + static_cast<long>(out) * L.in + q * out + o;
    grads[k] = g.l2_coef * weights[k] + s;
  }
}

__global__ void __launch_bounds__(kDwThreads, 2)
categorical_dw_kernel(const float* __restrict__ scratch,
                      const float* __restrict__ weights,
                      float* __restrict__ grads, float* __restrict__ l2,
                      const DwArgs g) {
  __shared__ __align__(16) float red[kDwWarps * 16 * kDwTile];
  const int blk = blockIdx.x;
  if (blk < g.tile0[g.n_lin]) {
    int l = 0;
    while (blk >= g.tile0[l + 1]) ++l;
    const DwLinear& L = g.lin[l];
    const int tiles_n = (L.in + kDwTile - 1) / kDwTile;
    const int t = blk - g.tile0[l];
    dw_tile(g, L, t / tiles_n * kDwTile, t % tiles_n * kDwTile, scratch,
            weights, grads, red);
    return;
  }
  if (blk < g.col0[g.n_lin]) {
    int l = 0;
    while (blk >= g.col0[l + 1]) ++l;
    dw_columns(g, g.lin[l], (blk - g.col0[l]) * kColChunk, scratch, weights,
               grads, red);
    return;
  }
  // l2 = 0.5 * l2_coef * sum w^2, in a fixed order.
  float s = 0.f;
  for (int k = threadIdx.x; k < g.n_weights; k += blockDim.x)
    s = fmaf(weights[k], weights[k], s);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kDwThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) l2[0] = 0.5f * g.l2_coef * red[0];
}

// Fills a tower's parameter offsets (from *off, in the parameters' order:
// per hidden layer W [out, in], b [out] and, for kind 1, the LayerNorm's
// scale and offset; then the heads) and its scratch offsets (from *cur, for
// `rows` rows). Returns false on a bad kind or layer count.
bool cat_tower(CatTower* tw, int in, int n, const int* widths,
               const int* kinds, int n_heads, const int* head_out, int rows,
               long* off, long* cur, int* max_w) {
  if (n < 1 || n > kMaxLayers) return false;
  auto take = [&](long floats) {
    const long at = *cur;
    *cur += floats;
    return at;
  };
  tw->n = n;
  tw->in = in;
  tw->n_heads = n_heads;
  tw->x0 = take(static_cast<long>(rows) * in);
  if (in > *max_w) *max_w = in;
  int width = in;
  for (int l = 0; l < n; ++l) {
    const int out = widths[l];
    if (kinds[l] != 0 && kinds[l] != 1) return false;
    tw->width[l] = out;
    tw->kind[l] = kinds[l];
    tw->w_off[l] = static_cast<int>(*off);
    *off += static_cast<long>(out) * width + out + (kinds[l] ? 2 * out : 0);
    tw->y[l] = take(static_cast<long>(rows) * out);
    tw->dz[l] = take(static_cast<long>(rows) * out);
    tw->xh[l] = kinds[l] ? take(static_cast<long>(rows) * out) : -1;
    tw->du[l] = kinds[l] ? take(static_cast<long>(rows) * out) : -1;
    tw->inv[l] = kinds[l] ? take(rows) : -1;
    if (out > *max_w) *max_w = out;
    width = out;
  }
  for (int h = 0; h < n_heads; ++h) {
    tw->head_out[h] = head_out[h];
    tw->head_off[h] = static_cast<int>(*off);
    *off += static_cast<long>(head_out[h]) * width + head_out[h];
    tw->hz[h] = take(static_cast<long>(rows) * head_out[h]);
    tw->dh[h] = take(static_cast<long>(rows) * head_out[h]);
    if (head_out[h] > *max_w) *max_w = head_out[h];
  }
  return true;
}

// The whole layout of a categorical launch; false when the shapes do not fit.
bool cat_layout(CatArgs* g, int O, int E, int A, int bins, int K,
                int n_repr, const int* repr_w, const int* repr_k, int n_pred,
                const int* pred_w, const int* pred_k, int n_dyn,
                const int* dyn_w, const int* dyn_k) {
  if (O < 1 || E < 1 || A < 1 || bins < 2 || K < 1) return false;
  g->O = O;
  g->E = E;
  g->A = A;
  g->bins = bins;
  g->K = K;
  const int T = kCatTile, KT = K * T;
  long off = 0, cur = 0;
  int max_w = 0;
  const int repr_heads[1] = {E};
  const int pred_heads[2] = {A, bins};
  const int dyn_heads[2] = {bins, E};
  if (!cat_tower(&g->repr, O, n_repr, repr_w, repr_k, 1, repr_heads, T, &off,
                 &cur, &max_w) ||
      !cat_tower(&g->pred, E, n_pred, pred_w, pred_k, 2, pred_heads, KT,
                 &off, &cur, &max_w) ||
      !cat_tower(&g->dyn, E + A, n_dyn, dyn_w, dyn_k, 2, dyn_heads, KT, &off,
                 &cur, &max_w))
    return false;
  g->n_weights = static_cast<int>(off);
  g->ds = cur;
  cur += static_cast<long>(T) * E;
  g->dsd = cur;  // [T, E], then the prediction's gradient into s [K*T, E]
  cur += static_cast<long>(T) * E + static_cast<long>(KT) * E;
  g->dx0 = cur;
  cur += static_cast<long>(KT) * max_w;
  g->dx1 = cur;
  cur += static_cast<long>(KT) * max_w;
  g->ce = cur;
  cur += 3L * KT + T;
  g->block_floats = (cur + 3) / 4 * 4;
  return true;
}

// The weight-gradient pass's block table: each linear's dW tiles, then its
// column-sum blocks, then the l2 block.
void dw_blocks(DwArgs* d) {
  auto up = [](int n, int by) { return (n + by - 1) / by; };
  d->tile0[0] = 0;
  for (int l = 0; l < d->n_lin; ++l)
    d->tile0[l + 1] = d->tile0[l] + up(d->lin[l].out, kDwTile) *
                                        up(d->lin[l].in, kDwTile);
  d->col0[0] = d->tile0[d->n_lin];
  for (int l = 0; l < d->n_lin; ++l)
    d->col0[l + 1] = d->col0[l] + up(d->lin[l].out, kColChunk);
}

// The weight-gradient pass's linears (the parameters' order) and its block
// table for G blocks of the first kernel.
void dw_layout(DwArgs* d, const CatArgs& g, int G, float l2_coef) {
  d->n_lin = 0;
  d->G = G;
  d->n_weights = g.n_weights;
  d->block_floats = g.block_floats;
  d->l2_coef = l2_coef;
  auto add = [&](long x, long dz, long xh, long du, int in, int out,
                 int rows, int w_off) {
    d->lin[d->n_lin++] = DwLinear{x, dz, xh, du, in, out, rows, w_off, in,
                                  out};
  };
  const CatTower* towers[3] = {&g.repr, &g.pred, &g.dyn};
  for (int t = 0; t < 3; ++t) {
    const CatTower& tw = *towers[t];
    const int rows = t == 0 ? kCatTile : g.K * kCatTile;
    int in = tw.in;
    for (int l = 0; l < tw.n; ++l) {
      add(l > 0 ? tw.y[l - 1] : tw.x0, tw.dz[l], tw.xh[l], tw.du[l], in,
          tw.width[l], rows, tw.w_off[l]);
      in = tw.width[l];
    }
    for (int h = 0; h < tw.n_heads; ++h)
      add(tw.y[tw.n - 1], tw.dh[h], -1, -1, in, tw.head_out[h], rows,
          tw.head_off[h]);
  }
  dw_blocks(d);
}

// The weight-gradient pass over the arenas of G tiles of the MLP spec's
// cluster pass: each linear's input rows and dz as mlp_layout lays them.
void mlp_dw_layout(DwArgs* d, const MlpArgs& g, int G, float l2_coef) {
  d->n_lin = g.n_lin;
  d->G = G;
  d->n_weights = g.n_weights;
  d->block_floats = g.arena_floats;
  d->l2_coef = l2_coef;
  for (int l = 0; l < g.n_lin; ++l)
    d->lin[l] = DwLinear{g.x[l], g.dz[l], -1, -1, g.din[l], g.dout[l],
                         g.rows[l], g.off[l], g.xs[l], g.ys[l]};
  dw_blocks(d);
}

}  // namespace

#define MZ_ERR_SHAPE (-1)
#define MZ_ERR_SCRATCH (-2)

extern "C" {

// Shared-memory floats of the MLP spec's weights (out[0]) and
// floats of one block's arena (out[1]); MZ_ERR_SHAPE when the shapes do not
// fit the kernel. Widths as mz_fused_muzero_grad's.
int mz_mlp_learner_floats(int O, int E, int A, int S41, int K, int n_repr,
                          const int* repr_w, int n_pred, const int* pred_w,
                          int n_dyn, const int* dyn_w, long* out) {
  MlpArgs g;
  if (!mlp_layout(&g, O, E, A, S41, K, n_repr, repr_w, n_pred, pred_w, n_dyn,
                  dyn_w))
    return MZ_ERR_SHAPE;
  out[0] = g.smem_weights;
  out[1] = g.arena_floats;
  return 0;
}

// Blocks of mlp_tile_kernel (the instance with its arena in shared memory
// or in the device scratch), or with `cluster` of mlp_cluster_kernel, that
// one SM holds at `smem_bytes` of shared memory each, by the CUDA
// occupancy calculator.
int mz_learner_blocks_per_sm(int smem_arena, int cluster, long smem_bytes,
                             int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto blocks = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kThreads, static_cast<size_t>(smem_bytes));
  };
  return cluster ? blocks(mlp_cluster_kernel)
                 : blocks(mlp_kernel(smem_arena != 0));
}

// Shared-memory bytes of a block of mlp_cluster_kernel (its staging ring
// and split-k sums), which the launch plan repeats.
long mz_learner_cluster_smem_bytes() { return 4L * kClusterSmemFloats; }

// Clusters of mlp_cluster_kernel of `cluster` blocks that the card holds
// at once, as the CUDA runtime reckons it (cudaOccupancyMaxActiveClusters);
// into *out.
int mz_learner_active_clusters(int cluster, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * kClusterSmemFloats);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 4 * kClusterSmemFloats;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, mlp_cluster_kernel, &config);
}

// Launch the MLP learner on `stream`: with cluster 0 (staged weights)
// mlp_tile_kernel over G = ceil(B / 16) blocks, then mlp_finish_kernel;
// with cluster 2, 4 or 8 (towers wider than a block's shared memory)
// mlp_cluster_kernel over G clusters of `cluster` blocks, then
// categorical_dw_kernel over the G arenas. raw: the fused sampler's
// rows, row r of window w at raw[r * ld + w] (ld >= B); coef [B]; weights:
// the flat parameters in the modules' order (per linear W [out, in] then
// b; towers representation, prediction, dynamics, heads as in MlpArgs).
// Outputs: grads [n_weights] in the same layout, met [4, B] (value, policy
// and reward cross-entropy sums over the valid steps, and the decoded value
// at step 0), l2 [1]. scratch: with staged weights the blocks' rows of
// weight gradients [G, n_weights], then, unless smem_arena, their arenas
// (G times mz_mlp_learner_floats' out[1]); with clusters the G arenas
// alone. smem_bytes: the shared memory of a block, the staged weights and,
// with smem_arena, the arena (with clusters the staging ring,
// mz_learner_cluster_smem_bytes; the launch plan's figures, which this
// checks). Returns a cudaError_t, MZ_ERR_SHAPE or
// MZ_ERR_SCRATCH.
int mz_fused_muzero_grad(const float* raw, int ld, const float* coef,
                         const float* weights, int n_weights, float* grads,
                         float* met, float* l2, float* scratch,
                         long scratch_floats, int G, int smem_arena,
                         int cluster, long smem_bytes, int B, int O,
                         int E, int A, int S41, int support, int K,
                         int n_repr, const int* repr_w, int n_pred,
                         const int* pred_w, int n_dyn,
                         const int* dyn_w, int r_obs, int r_action,
                         int r_reward, int r_rn, int r_pi, int r_mask,
                         float gradient_scale, float l2_coef, int device,
                         void* stream) {
  MlpArgs g;
  if (B < 1 || ld < B || G != (B + kTile - 1) / kTile ||
      !mlp_layout(&g, O, E, A, S41, K, n_repr, repr_w, n_pred, pred_w, n_dyn,
                  dyn_w) ||
      g.n_weights != n_weights ||
      (cluster != 0 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (cluster != 0 && smem_arena))
    return MZ_ERR_SHAPE;
  const MlpKernel kernel = mlp_kernel(smem_arena != 0);
  const long smem = cluster ? 4L * kClusterSmemFloats
                           : 4L * (g.smem_weights +
                                   (smem_arena ? g.arena_floats : 0));
  if (smem != smem_bytes) return MZ_ERR_SHAPE;
  const long partial_floats = cluster ? 0 : static_cast<long>(G) * n_weights;
  if (scratch_floats <
      partial_floats + (smem_arena ? 0 : static_cast<long>(G) *
                                             g.arena_floats))
    return MZ_ERR_SCRATCH;
  g.B = B;
  g.ld = ld;
  g.support = support;
  g.r_obs = r_obs;
  g.r_action = r_action;
  g.r_reward = r_reward;
  g.r_rn = r_rn;
  g.r_pi = r_pi;
  g.r_mask = r_mask;
  g.gradient_scale = gradient_scale;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster) {
    err = cudaFuncSetAttribute(mlp_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(G * cluster);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, mlp_cluster_kernel, raw, coef, weights,
                             scratch, met, g);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    DwArgs d;
    mlp_dw_layout(&d, g, G, l2_coef);
    categorical_dw_kernel<<<d.col0[d.n_lin] + 1, kDwThreads, 0, st>>>(
        scratch, weights, grads, l2, d);
    return cudaGetLastError();
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > max_smem) return MZ_ERR_SHAPE;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<G, kThreads, smem, st>>>(raw, coef, weights,
                                    scratch + partial_floats, scratch, met, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_finish_kernel<<<(n_weights + kFinishCols - 1) / kFinishCols + 1,
                      kFinishThreads, 0, st>>>(scratch, G, n_weights, weights,
                                               l2_coef, grads, l2);
  return cudaGetLastError();
}

// Floats of device scratch a categorical launch of G blocks of kCatTile
// windows needs, or -1 when the shapes do not fit (towers as
// mz_fused_categorical_grad's).
long mz_categorical_scratch_floats(int G, int O, int E, int A, int bins,
                                   int K, int n_repr, const int* repr_w,
                                   const int* repr_k, int n_pred,
                                   const int* pred_w, const int* pred_k,
                                   int n_dyn, const int* dyn_w,
                                   const int* dyn_k) {
  CatArgs g;
  if (!cat_layout(&g, O, E, A, bins, K, n_repr, repr_w, repr_k, n_pred,
                  pred_w, pred_k, n_dyn, dyn_w, dyn_k))
    return -1;
  return static_cast<long>(G) * g.block_floats;
}

// Launch the categorical learner on `stream`: categorical_tile_kernel over
// G = ceil(B / kCatTile) blocks, then categorical_dw_kernel. raw, coef and
// the outputs as mz_fused_muzero_grad; weights: the flat parameters in the
// modules' order (representation: hidden layers, then the embedding head;
// prediction: hidden layers, policy head, value head; dynamics: hidden
// layers, reward head, next-state head; per hidden layer W [out, in], b
// [out] and, for kind 1 (ln_tanh; kind 0 is elu), the LayerNorm's scale
// [out] and offset [out]). scratch holds mz_categorical_scratch_floats(G,
// ...) floats. Returns a cudaError_t, MZ_ERR_SHAPE or MZ_ERR_SCRATCH.
int mz_fused_categorical_grad(
    const float* raw, int ld, const float* coef, const float* weights,
    int n_weights, float* grads, float* met, float* l2, float* scratch,
    long scratch_floats, int G, int B, int O, int E, int A, int bins,
    float vmin, float vmax, int K, int n_repr, const int* repr_w,
    const int* repr_k, int n_pred, const int* pred_w, const int* pred_k,
    int n_dyn, const int* dyn_w, const int* dyn_k, int r_obs, int r_action,
    int r_reward, int r_rn, int r_pi, int r_mask, float gradient_scale,
    float l2_coef, int device, void* stream) {
  CatArgs g;
  if (B < 1 || ld < B || G != (B + kCatTile - 1) / kCatTile ||
      !cat_layout(&g, O, E, A, bins, K, n_repr, repr_w, repr_k, n_pred,
                  pred_w, pred_k, n_dyn, dyn_w, dyn_k) ||
      g.n_weights != n_weights)
    return MZ_ERR_SHAPE;
  if (scratch_floats < static_cast<long>(G) * g.block_floats)
    return MZ_ERR_SCRATCH;
  g.B = B;
  g.ld = ld;
  g.vmin = vmin;
  g.vmax = vmax;
  g.bin_step = static_cast<float>((static_cast<double>(vmax) - vmin) /
                                  (bins - 1));
  g.gradient_scale = gradient_scale;
  g.r_obs = r_obs;
  g.r_action = r_action;
  g.r_reward = r_reward;
  g.r_rn = r_rn;
  g.r_pi = r_pi;
  g.r_mask = r_mask;
  DwArgs d;
  dw_layout(&d, g, G, l2_coef);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  categorical_tile_kernel<<<G, kCatThreads, 0, st>>>(raw, coef, weights,
                                                     scratch, met, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  categorical_dw_kernel<<<d.col0[d.n_lin] + 1, kDwThreads, 0, st>>>(
      scratch, weights, grads, l2, d);
  return cudaGetLastError();
}

const char* mz_learner_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused learner kernel";
  if (code == MZ_ERR_SCRATCH)
    return "the scratch has too few rows or floats";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
