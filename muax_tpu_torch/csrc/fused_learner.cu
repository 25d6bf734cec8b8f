// Fused MuZero learner: the K-step unrolled loss and its hand-derived
// backward for a batch of windows, for Hopper (sm_90a). The MLP spec's
// fused_muzero_grad_kernel (below) ends in finish_grads_kernel; the
// categorical LearnerSpec's is categorical_tile_kernel and the
// weight-gradient pass categorical_dw_kernel (entry
// mz_fused_categorical_grad, whose design is described at the kernels).
//
// Replaces the TPU kernel muax_tpu/models/fused_learner.py `_make_kernel`
// in raw mode with the MLP spec (elu towers, h-support heads), which
// `_run_kernel` launches through pl.pallas_call
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
//
// What bounds it on this card. Per window the forward is about 9,000
// multiply-adds at the flagship widths and the backward about twice that,
// so a launch of 4,096 windows is about 0.22 GFLOP: 3.3 us at the f32 peak.
// It reads well under a megabyte. So the bound is by operations. The real
// limit of this first version is latency: every layer is a dependent step
// on a few dozen values, done by one warp.
//
// What the design does about it. One warp owns one window at a time, its
// lanes over the output features of each layer. The weights (about 8.4 KB)
// are staged once per block in shared memory; each warp keeps its window's
// forward activations (about 700 floats at K = 5) and its own weight-gradient
// accumulator in shared memory, so nothing but the raw rows, the weights and
// the per-block sums touches device memory. On the TPU the grid runs in
// order and the gradient accumulates in VMEM across tiles; on Hopper the
// blocks run in parallel, so each block writes its sum to one row of a
// [G, n_weights] scratch and a second kernel adds the G rows in a fixed
// order, then `l2_coef * p`. Nothing uses float atomics, so two launches on
// the same inputs give bit-identical gradients. A block always takes 16
// windows; when eight warps' slices do not fit its shared memory (towers
// wider than the flagship's, such as the (64, 64, 16) of the CartPole notebook
// config), fewer warps share them.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "tc_tile.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxLin = 3 * kMaxLayers + 5;
constexpr int kWarps = 8;           // most warps (windows in flight) per block
constexpr int kWindowsPerWarp = 2;  // windows each of kWarps warps takes
constexpr int kBlockWindows = kWarps * kWindowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHEps = 1e-3f;
constexpr float kMMEps = 1e-8f;

struct Args {
  int B, ld, O, E, A, S41, support, K;
  int n_repr, n_pred, n_dyn;
  // Linear l: weight [dout, din] at off[l], bias [dout] right after it.
  // Order: repr hidden, repr head, pred hidden, value, policy, dyn hidden,
  // reward, next state (the modules' parameters() order).
  int off[kMaxLin], din[kMaxLin], dout[kMaxLin];
  // Offset of hidden layer l's activation inside its tower's stash.
  int hoff[kMaxLin];
  int r_obs, r_action, r_reward, r_rn, r_pi, r_mask;
  int n_weights, w_stride, warp_floats, step_floats, max_w;
  int warps;  // warps per block: kWarps, or fewer when their slices don't fit
  int o_obs, o_repr, o_spre0, o_steps, o_scratch;  // inside a warp's slice
  int so_s, so_pred, so_v, so_p, so_dyn, so_r, so_spre;  // inside a step
  float gradient_scale;
};

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

// y[o] = W[o, :] . x + b[o], then elu if `act`; lanes over outputs.
__device__ void dense(const float* W, const float* x, float* y, int in,
                      int out, bool act, int lane) {
  const float* b = W + in * out;
  for (int o = lane; o < out; o += 32) {
    const float* row = W + o * in;
    float acc = 0.f;
    for (int k = 0; k < in; ++k) acc = fmaf(row[k], x[k], acc);
    acc += b[o];
    y[o] = act ? elu(acc) : acc;
  }
  __syncwarp();
}

// The dynamics' first layer on concat(s [E], one_hot(a) [A]), then elu.
__device__ void dense_sa(const float* W, const float* s, int a, float* y,
                         int E, int A, int out, int lane) {
  const int in = E + A;
  const float* b = W + in * out;
  const bool has_a = a >= 0 && a < A;
  for (int o = lane; o < out; o += 32) {
    const float* row = W + o * in;
    float acc = 0.f;
    for (int k = 0; k < E; ++k) acc = fmaf(row[k], s[k], acc);
    if (has_a) acc += row[E + a];
    acc += b[o];
    y[o] = elu(acc);
  }
  __syncwarp();
}

// dx[k] (+)= sum_o W[o, k] dz[o] for k < n; lanes over k.
__device__ void dense_t(const float* W, const float* dz, float* dx, int in,
                        int out, int n, bool accumulate, int lane) {
  for (int k = lane; k < n; k += 32) {
    float acc = accumulate ? dx[k] : 0.f;
    for (int o = 0; o < out; ++o) acc = fmaf(W[o * in + k], dz[o], acc);
    dx[k] = acc;
  }
  __syncwarp();
}

// dW[o, k] += dz[o] x[k], db[o] += dz[o]; each element owned by one lane.
__device__ void acc_outer(float* dW, const float* dz, const float* x, int in,
                          int out, int lane) {
  for (int idx = lane; idx < out * in; idx += 32) {
    const int o = idx / in;
    dW[idx] += dz[o] * x[idx - o * in];
  }
  float* db = dW + in * out;
  for (int o = lane; o < out; o += 32) db[o] += dz[o];
  __syncwarp();
}

// acc_outer with x = concat(s [E], one_hot(a) [A]).
__device__ void acc_outer_sa(float* dW, const float* dz, const float* s,
                             int a, int E, int A, int out, int lane) {
  const int in = E + A;
  for (int idx = lane; idx < out * in; idx += 32) {
    const int o = idx / in;
    const int k = idx - o * in;
    const float x = k < E ? s[k] : (k - E == a ? 1.f : 0.f);
    dW[idx] += dz[o] * x;
  }
  float* db = dW + in * out;
  for (int o = lane; o < out; o += 32) db[o] += dz[o];
  __syncwarp();
}

// y = (x - min) / max(max - min, 1e-8).
__device__ void minmax(const float* x, float* y, int n, int lane) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    lo = fminf(lo, x[j]);
    hi = fmaxf(hi, x[j]);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const float d = fmaxf(hi - lo, kMMEps);
  for (int j = lane; j < n; j += 32) y[j] = (x[j] - lo) / d;
  __syncwarp();
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

// Forward and backward of one window; adds its weight gradients to dW.
__device__ void run_window(const Args& g, const float* Wt, float* dW,
                           float* sl, const float* __restrict__ raw,
                           const float* __restrict__ coef,
                           float* __restrict__ met, int w, int lane) {
  const size_t ld = static_cast<size_t>(g.ld);
  const int E = g.E, A = g.A, S41 = g.S41, K = g.K;
  const int l_repr_out = g.n_repr;
  const int l_pred0 = g.n_repr + 1;
  const int l_value = l_pred0 + g.n_pred, l_policy = l_value + 1;
  const int l_dyn0 = l_policy + 1;
  const int l_reward = l_dyn0 + g.n_dyn, l_state = l_reward + 1;
  auto rawv = [&](int row) { return raw[row * ld + w]; };
  auto Wl = [&](int l) { return Wt + g.off[l]; };
  auto dWl = [&](int l) { return dW + g.off[l]; };

  float* obs = sl + g.o_obs;
  float* repr = sl + g.o_repr;
  float* spre0 = sl + g.o_spre0;
  float* steps = sl + g.o_steps;
  float* DS = sl + g.o_scratch;   // gradient into the current state [E]
  float* T1 = DS + E;             // gradient into a pre-norm state [E]
  float* DD = T1 + E;             // gradient into s from the dynamics [E]
  float* H1 = DD + E;
  float* H2 = H1 + g.max_w;
  float* bufs[2] = {H2 + g.max_w, H2 + 2 * g.max_w};

  // ---- forward ------------------------------------------------------------
  for (int f = lane; f < g.O; f += 32) obs[f] = rawv(g.r_obs + f);
  __syncwarp();
  const float* x = obs;
  int in = g.O;
  for (int l = 0; l < g.n_repr; ++l) {
    float* y = repr + g.hoff[l];
    dense(Wl(l), x, y, in, g.dout[l], true, lane);
    x = y;
    in = g.dout[l];
  }
  const float* repr_last = x;
  const int repr_last_w = in;
  dense(Wl(l_repr_out), x, spre0, in, E, false, lane);
  minmax(spre0, steps + g.so_s, E, lane);

  float v_sum = 0.f, p_sum = 0.f, r_sum = 0.f, v0 = 0.f;
  for (int i = 0; i < K; ++i) {
    float* st = steps + i * g.step_floats;
    const float* s = st + g.so_s;
    const float mask = rawv(g.r_mask + i);
    // prediction
    x = s;
    in = E;
    for (int l = 0; l < g.n_pred; ++l) {
      float* y = st + g.so_pred + g.hoff[l_pred0 + l];
      dense(Wl(l_pred0 + l), x, y, in, g.dout[l_pred0 + l], true, lane);
      x = y;
      in = g.dout[l_pred0 + l];
    }
    float* vz = st + g.so_v;
    dense(Wl(l_value), x, vz, in, S41, false, lane);
    const float ce_v =
        softmax_ce(vz, S41, two_hot(rawv(g.r_rn + i), g.support), lane);
    if (i == 0) {
      float ev = 0.f;
      for (int j = lane; j < S41; j += 32)
        ev += vz[j] * static_cast<float>(j - g.support);
      v0 = inv_value_transform(warp_sum(ev));
    }
    float* pz = st + g.so_p;
    dense(Wl(l_policy), x, pz, in, A, false, lane);
    const int pi_row = g.r_pi + i * A;
    const float ce_p =
        softmax_ce(pz, A, [&](int j) { return rawv(pi_row + j); }, lane);
    v_sum += mask * ce_v;
    p_sum += mask * ce_p;
    // dynamics
    const int a = static_cast<int>(rawv(g.r_action + i));
    float* y = st + g.so_dyn + g.hoff[l_dyn0];
    dense_sa(Wl(l_dyn0), s, a, y, E, A, g.dout[l_dyn0], lane);
    x = y;
    in = g.dout[l_dyn0];
    for (int l = 1; l < g.n_dyn; ++l) {
      y = st + g.so_dyn + g.hoff[l_dyn0 + l];
      dense(Wl(l_dyn0 + l), x, y, in, g.dout[l_dyn0 + l], true, lane);
      x = y;
      in = g.dout[l_dyn0 + l];
    }
    float* rz = st + g.so_r;
    dense(Wl(l_reward), x, rz, in, S41, false, lane);
    r_sum += mask * softmax_ce(rz, S41, two_hot(rawv(g.r_reward + i),
                                                g.support), lane);
    float* spre = st + g.so_spre;
    dense(Wl(l_state), x, spre, in, E, false, lane);
    if (i + 1 < K) minmax(spre, st + g.step_floats + g.so_s, E, lane);
  }
  if (lane == 0) {
    met[w] = v_sum;
    met[g.B + w] = p_sum;
    met[2 * g.B + w] = r_sum;
    met[3 * g.B + w] = v0;
  }

  // ---- backward -----------------------------------------------------------
  const float c = coef[w];
  for (int j = lane; j < E; j += 32) DS[j] = 0.f;
  __syncwarp();
  for (int i = K - 1; i >= 0; --i) {
    float* st = steps + i * g.step_floats;
    const float* s = st + g.so_s;
    const float cm = c * rawv(g.r_mask + i);
    // dynamics branch: reward head, next-state head through the normaliser
    minmax_bwd(st + g.so_spre, DS, T1, E, lane);
    const TwoHot rt = two_hot(rawv(g.r_reward + i), g.support);
    const float* rz = st + g.so_r;
    for (int j = lane; j < S41; j += 32) H1[j] = cm * (rz[j] - rt(j));
    __syncwarp();
    const int last_d = l_dyn0 + g.n_dyn - 1;
    const float* gd = st + g.so_dyn + g.hoff[last_d];
    const int hd = g.dout[last_d];
    acc_outer(dWl(l_reward), H1, gd, hd, S41, lane);
    acc_outer(dWl(l_state), T1, gd, hd, E, lane);
    float* dy = bufs[0];
    float* dx = bufs[1];
    dense_t(Wl(l_reward), H1, dy, hd, S41, hd, false, lane);
    dense_t(Wl(l_state), T1, dy, hd, E, hd, true, lane);
    const int a = static_cast<int>(rawv(g.r_action + i));
    for (int l = g.n_dyn - 1; l >= 0; --l) {
      const int L = l_dyn0 + l;
      const float* y = st + g.so_dyn + g.hoff[L];
      for (int o = lane; o < g.dout[L]; o += 32)
        dy[o] *= y[o] > 0.f ? 1.f : y[o] + 1.f;
      __syncwarp();
      if (l > 0) {
        const float* xin = st + g.so_dyn + g.hoff[L - 1];
        acc_outer(dWl(L), dy, xin, g.din[L], g.dout[L], lane);
        dense_t(Wl(L), dy, dx, g.din[L], g.dout[L], g.din[L], false, lane);
        float* t = dy;
        dy = dx;
        dx = t;
      } else {
        acc_outer_sa(dWl(L), dy, s, a, E, A, g.dout[L], lane);
        dense_t(Wl(L), dy, DD, g.din[L], g.dout[L], E, false, lane);
      }
    }
    // prediction branch: value and policy heads
    const TwoHot vt = two_hot(rawv(g.r_rn + i), g.support);
    const float* vz = st + g.so_v;
    const float* pz = st + g.so_p;
    const int pi_row = g.r_pi + i * A;
    for (int j = lane; j < S41; j += 32) H1[j] = cm * (vz[j] - vt(j));
    for (int j = lane; j < A; j += 32) H2[j] = cm * (pz[j] - rawv(pi_row + j));
    __syncwarp();
    const int last_p = l_pred0 + g.n_pred - 1;
    const float* hp = st + g.so_pred + g.hoff[last_p];
    const int wp = g.dout[last_p];
    acc_outer(dWl(l_value), H1, hp, wp, S41, lane);
    acc_outer(dWl(l_policy), H2, hp, wp, A, lane);
    dy = bufs[0];
    dx = bufs[1];
    dense_t(Wl(l_value), H1, dy, wp, S41, wp, false, lane);
    dense_t(Wl(l_policy), H2, dy, wp, A, wp, true, lane);
    for (int l = g.n_pred - 1; l >= 0; --l) {
      const int L = l_pred0 + l;
      const float* y = st + g.so_pred + g.hoff[L];
      for (int o = lane; o < g.dout[L]; o += 32)
        dy[o] *= y[o] > 0.f ? 1.f : y[o] + 1.f;
      __syncwarp();
      const float* xin = l > 0 ? st + g.so_pred + g.hoff[L - 1] : s;
      acc_outer(dWl(L), dy, xin, g.din[L], g.dout[L], lane);
      dense_t(Wl(L), dy, dx, g.din[L], g.dout[L], g.din[L], false, lane);
      float* t = dy;
      dy = dx;
      dx = t;
    }
    // s feeds prediction as is and the dynamics through scale_gradient.
    for (int j = lane; j < E; j += 32)
      DS[j] = dy[j] + g.gradient_scale * DD[j];
    __syncwarp();
  }

  // representation: head through the normaliser, then the hidden layers
  minmax_bwd(spre0, DS, T1, E, lane);
  acc_outer(dWl(l_repr_out), T1, repr_last, repr_last_w, E, lane);
  if (g.n_repr > 0) {
    float* dy = bufs[0];
    float* dx = bufs[1];
    dense_t(Wl(l_repr_out), T1, dy, repr_last_w, E, repr_last_w, false, lane);
    for (int l = g.n_repr - 1; l >= 0; --l) {
      const float* y = repr + g.hoff[l];
      for (int o = lane; o < g.dout[l]; o += 32)
        dy[o] *= y[o] > 0.f ? 1.f : y[o] + 1.f;
      __syncwarp();
      const float* xin = l > 0 ? repr + g.hoff[l - 1] : obs;
      acc_outer(dWl(l), dy, xin, g.din[l], g.dout[l], lane);
      if (l > 0) {
        dense_t(Wl(l), dy, dx, g.din[l], g.dout[l], g.din[l], false, lane);
        float* t = dy;
        dy = dx;
        dx = t;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
fused_muzero_grad_kernel(const float* __restrict__ raw,
                         const float* __restrict__ coef,
                         const float* __restrict__ weights,
                         float* __restrict__ partial, float* __restrict__ met,
                         const Args args) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < args.n_weights; i += blockDim.x)
    smem[i] = weights[i];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* slice = smem + args.w_stride + warp * args.warp_floats;
  float* dW = slice;  // the warp's gradient sum, in the weights' layout
  for (int i = lane; i < args.n_weights; i += 32) dW[i] = 0.f;
  __syncthreads();

  // A block takes kBlockWindows windows whatever its warps; each warp takes
  // a run of them in turn.
  const int per_warp = (kBlockWindows + args.warps - 1) / args.warps;
  for (int k = 0; k < per_warp; ++k) {
    const int local = warp * per_warp + k;
    const int w = blockIdx.x * kBlockWindows + local;
    if (local >= kBlockWindows || w >= args.B) break;
    run_window(args, smem, dW, slice, raw, coef, met, w, lane);
  }
  __syncthreads();

  // The block's sum, warps added in a fixed order.
  for (int i = threadIdx.x; i < args.n_weights; i += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < args.warps; ++v)
      s += smem[args.w_stride + v * args.warp_floats + i];
    partial[static_cast<size_t>(blockIdx.x) * args.n_weights + i] = s;
  }
}

constexpr int kFinishThreads = 256;

// grads[k] = l2_coef * w[k] + sum_g partial[g, k] (g in order); the last
// block computes l2 = 0.5 * l2_coef * sum w^2 with a fixed-order reduction.
__global__ void __launch_bounds__(kFinishThreads)
finish_grads_kernel(const float* __restrict__ partial, int G, int n,
                    const float* __restrict__ weights, float l2_coef,
                    float* __restrict__ grads, float* __restrict__ l2) {
  if (blockIdx.x + 1 < gridDim.x) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) return;
    float acc = 0.f;
    for (int b = 0; b < G; ++b) acc += partial[static_cast<size_t>(b) * n + k];
    grads[k] = l2_coef * weights[k] + acc;
    return;
  }
  __shared__ float red[kFinishThreads];
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

// ---- the categorical LearnerSpec: two kernels --------------------------
//
// Replaces the same TPU kernel with the categorical spec
// (`extract_categorical_learner_spec`, muax_tpu/models/fused_learner.py:180):
// LayerNorm-tanh first layers (backward at :476-485) and linear [vmin, vmax]
// two-hot targets (:371-381), v0 the linear expectation (:523-525). At the
// widths of bench.py's categorical_training (three towers of (256, 256,
// 256), about 490 K weights) neither the weights nor one warp's gradient sum
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
// first kernel holds, and where W [out, in] starts in the flat parameters
// (b [out] follows, then the LayerNorm's scale and offset).
struct DwLinear {
  long x, dz, xh, du;
  int in, out, rows, w_off;
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
          out - mh, in - n0, L.rows, dz + mh, 1, out, x + n0, in, 1, acc);
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
        db += blk[L.dz + at];
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
    d->lin[d->n_lin++] = DwLinear{x, dz, xh, du, in, out, rows, w_off};
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
  auto up = [](int n, int by) { return (n + by - 1) / by; };
  d->tile0[0] = 0;
  for (int l = 0; l < d->n_lin; ++l)
    d->tile0[l + 1] = d->tile0[l] + up(d->lin[l].out, kDwTile) *
                                        up(d->lin[l].in, kDwTile);
  d->col0[0] = d->tile0[d->n_lin];
  for (int l = 0; l < d->n_lin; ++l)
    d->col0[l + 1] = d->col0[l] + up(d->lin[l].out, kColChunk);
}

}  // namespace

#define MZ_ERR_SHAPE (-1)
#define MZ_ERR_SCRATCH (-2)

extern "C" {

// Blocks of a launch over B windows: the rows of the scratch `partial`.
int mz_fused_grad_blocks(int B) {
  return (B + kBlockWindows - 1) / kBlockWindows;
}

// Launch the learner on `stream`. raw: the fused sampler's rows, row r of
// window w at raw[r * ld + w] (ld >= B); coef [B]; weights: the flat
// parameters in the modules' order (per linear W [out, in] then b; towers
// representation, prediction, dynamics, heads as in the Args comment).
// Outputs: grads [n_weights] in the same layout, met [4, B] (value, policy
// and reward cross-entropy sums over the valid steps, and the decoded value
// at step 0), l2 [1]. partial is scratch of [mz_fused_grad_blocks(B),
// n_weights]. Returns a cudaError_t, MZ_ERR_SHAPE or MZ_ERR_SCRATCH.
int mz_fused_muzero_grad(const float* raw, int ld, const float* coef,
                         const float* weights, int n_weights, float* grads,
                         float* met, float* l2, float* partial,
                         int partial_rows, int B, int O, int E, int A,
                         int S41, int support, int K, int n_repr,
                         const int* repr_w, int n_pred, const int* pred_w,
                         int n_dyn, const int* dyn_w, int r_obs, int r_action,
                         int r_reward, int r_rn, int r_pi, int r_mask,
                         float gradient_scale, float l2_coef, int device,
                         void* stream) {
  if (B < 1 || ld < B || O < 1 || E < 1 || A < 1 || S41 < 1 || K < 1 ||
      n_repr < 0 || n_repr > kMaxLayers || n_pred < 1 ||
      n_pred > kMaxLayers || n_dyn < 1 || n_dyn > kMaxLayers)
    return MZ_ERR_SHAPE;
  if (partial_rows < mz_fused_grad_blocks(B)) return MZ_ERR_SCRATCH;
  Args g;
  g.B = B;
  g.ld = ld;
  g.O = O;
  g.E = E;
  g.A = A;
  g.S41 = S41;
  g.support = support;
  g.K = K;
  g.n_repr = n_repr;
  g.n_pred = n_pred;
  g.n_dyn = n_dyn;
  g.r_obs = r_obs;
  g.r_action = r_action;
  g.r_reward = r_reward;
  g.r_rn = r_rn;
  g.r_pi = r_pi;
  g.r_mask = r_mask;
  g.gradient_scale = gradient_scale;

  // The linear table, in the modules' parameter order.
  int n_lin = 0, off = 0, max_w = S41;
  if (E > max_w) max_w = E;
  if (A > max_w) max_w = A;
  auto add = [&](int in, int out, int* stash, bool hidden) {
    g.off[n_lin] = off;
    g.din[n_lin] = in;
    g.dout[n_lin] = out;
    g.hoff[n_lin] = hidden ? *stash : 0;
    if (hidden) *stash += out;
    if (out > max_w) max_w = out;
    off += in * out + out;
    ++n_lin;
  };
  int repr_floats = 0, pred_floats = 0, dyn_floats = 0, in = O;
  for (int l = 0; l < n_repr; ++l) {
    add(in, repr_w[l], &repr_floats, true);
    in = repr_w[l];
  }
  add(in, E, nullptr, false);
  in = E;
  for (int l = 0; l < n_pred; ++l) {
    add(in, pred_w[l], &pred_floats, true);
    in = pred_w[l];
  }
  add(in, S41, nullptr, false);
  add(in, A, nullptr, false);
  in = E + A;
  for (int l = 0; l < n_dyn; ++l) {
    add(in, dyn_w[l], &dyn_floats, true);
    in = dyn_w[l];
  }
  add(in, S41, nullptr, false);
  add(in, E, nullptr, false);
  if (off != n_weights) return MZ_ERR_SHAPE;
  g.n_weights = n_weights;
  g.w_stride = (n_weights + 3) / 4 * 4;
  g.max_w = max_w;

  // A step's stash: s, prediction activations, value probs, policy probs,
  // dynamics activations, reward probs, pre-norm next state.
  g.so_s = 0;
  g.so_pred = g.so_s + E;
  g.so_v = g.so_pred + pred_floats;
  g.so_p = g.so_v + S41;
  g.so_dyn = g.so_p + A;
  g.so_r = g.so_dyn + dyn_floats;
  g.so_spre = g.so_r + S41;
  g.step_floats = g.so_spre + E;
  // A warp's slice: gradient sum, obs, representation activations, pre-norm
  // s0, K steps, scratch (3 state vectors and 4 layer-wide buffers).
  g.o_obs = g.w_stride;
  g.o_repr = g.o_obs + O;
  g.o_spre0 = g.o_repr + repr_floats;
  g.o_steps = g.o_spre0 + E;
  g.o_scratch = g.o_steps + K * g.step_floats;
  g.warp_floats = (g.o_scratch + 3 * E + 4 * max_w + 3) / 4 * 4;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // Each warp's slice holds a whole gradient sum, so wide towers fit fewer
  // warps: take as many as fit, down to one.
  auto smem_for = [&](int warps) {
    return (static_cast<size_t>(g.w_stride) +
            static_cast<size_t>(warps) * g.warp_floats) * sizeof(float);
  };
  g.warps = kWarps;
  while (g.warps > 0 && smem_for(g.warps) > static_cast<size_t>(max_smem))
    --g.warps;
  if (g.warps == 0) return MZ_ERR_SHAPE;
  const size_t smem = smem_for(g.warps);
  err = cudaFuncSetAttribute(fused_muzero_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  const int G = mz_fused_grad_blocks(B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_muzero_grad_kernel<<<G, 32 * g.warps, smem, st>>>(raw, coef, weights,
                                                          partial, met, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid2 = (n_weights + kFinishThreads - 1) / kFinishThreads + 1;
  finish_grads_kernel<<<grid2, kFinishThreads, 0, st>>>(
      partial, G, n_weights, weights, l2_coef, grads, l2);
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
