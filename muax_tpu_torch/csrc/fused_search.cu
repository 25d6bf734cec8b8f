// Fused search: every simulation of every environment in one launch, for
// Hopper (sm_90a), in the two policy modes of the TPU kernel, for the MLP
// triplet (fused_search_kernel: one warp per environment, everything in
// shared memory) and for the acme categorical family
// (fused_search_tiled_kernel, entry mz_fused_tiled_search: LayerNorm-tanh
// layers and the linear two-hot decode, `decode="linear"` with ln_tanh
// towers in the TPU kernel; its design is described at the kernel).
//
// Replaces the TPU kernel muax_tpu/search/fused.py `_make_kernel` with
// decode="h_support" and elu towers, which `_fused_search` launches through
// pl.pallas_call (muax_tpu/search/fused.py:759): policy="muzero" (entry
// mz_fused_muzero_search) and policy="gumbel" (entry mz_fused_gumbel_search,
// the TPU body's :434-517, :546-552 and :640-644). The plain PyTorch versions
// of the same functions are `fused_muzero_search_reference` and
// `fused_gumbel_search_reference` in muax_tpu_torch/search/fused.py.
//
// What bounds it on this card. One expansion is a few thousand multiply-adds
// (at the flagship widths 1,760: dynamics 10x16 + 16x41 + 16x8, prediction
// 8x16 + 16x41 + 16x2), and one launch reads and writes well under a
// megabyte, so neither the f32 rate nor the memory rate is the limit. The
// limit is the chain of dependent steps inside each environment: every
// simulation walks down the tree (one selection per level, each needing the
// previous one's child index), runs the two towers, then walks back up to the
// root, and the next simulation needs the updated statistics. The chain is
// latency-bound shared-memory traffic, not arithmetic.
//
// What the design does about it. One warp owns one environment, and its
// whole tree lives in shared memory: int32 parent, action and child indices,
// f32 statistics, the embeddings. Nothing goes to device memory between the
// root read and the summary write. The tower weights (about 1.9 K floats at
// the flagship widths) are staged once per block in shared memory. Lanes
// split the actions during selection (warp shuffles find the max, ties go to
// the lowest action), the output rows of each dense layer, and the 2S+1-bin
// softmax and expectation. Tree edits and the backup run on lane 0 with the
// warp synchronised around them. Several warps (environments) share a block
// so the latency of one environment's chain hides behind the others'. The
// tensor-core path, persistence and a tuned occupancy are left for later.
//
// Semantics are those of the TPU kernel: node 0 starts with one visit and
// the root value; root priors are softmax(root logits); the first maximum
// wins; the descent stops at an unexpanded child or at max_depth, and a
// depth-capped descent re-evaluates the existing child in place; expansion
// is dynamics + prediction with h-support decode and a min-max normalised
// next state; the install is a running mean; the backup starts from the raw
// network value.
//
// MuZero mode: PUCT under the parent-and-siblings qtransform, invalid actions
// masked at depth 0 only. Gumbel mode, under completed_by_mix_value (the mix
// reads each node's raw network value, kept in `nraw` and replaced when a
// depth-capped descent re-evaluates the node, and the sum and max of the
// children's visits): at depth 0, sequential halving, g + logits + sigma(q)
// among the actions whose visits equal this simulation's entry of the row's
// schedule (visits are exact small integers in f32 on both sides), invalid
// actions masked; below, softmax(log prior + sigma(q)) - n / (1 + sum n); the
// third output is the root's sigma(q), not r + discount v. A masked score is
// the finite kNeg, so a row whose every score is masked takes action 0, as
// the TPU kernel's lowest-row tie-break does.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "tile_gemm.cuh"

// Returned when the shapes do not fit the kernel (too many layers, or one
// environment's tree does not fit the shared memory of a block).
#define MZ_ERR_SHAPE (-1)

namespace {

constexpr int kErrShape = MZ_ERR_SHAPE;
constexpr int kMaxLayers = 8;
constexpr int kMaxEnvsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr float kHEps = 1e-3f;
// completed_by_mix_value's defaults (muax_tpu/search/qtransforms.py:58-59).
constexpr float kValueScale = 0.1f;
constexpr float kMaxvisitInit = 50.0f;

struct Args {
  int B, A, E, S41, support_size;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dyn, n_pred;
  int dyn_width[kMaxLayers];
  int pred_width[kMaxLayers];
  int pred_offset;     // floats: start of the prediction tower's weights
  int n_weights;       // floats in the flat weight buffer
  int weights_stride;  // floats of shared memory reserved for the weights
  int act_width;       // floats per activation buffer
  int env_floats;      // floats of shared memory per environment
  int envs_per_block;
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

// The tree of one environment in shared memory.
struct Forest {
  float* nvis;  // [N]
  float* nval;  // [N]
  float* nraw;  // [N], Gumbel mode only
  int* npar;    // [N]
  int* nact;    // [N]
  int* cidx;    // [N, A]
  float* cpri;  // [N, A]
  float* cvis;  // [N, A]
  float* crew;  // [N, A]
  float* cval;  // [N, A]
};

// completed_by_mix_value at one node: sigma(q)(a) = (50 + max_a n(a)) * 0.1
// * (completed(a) - low) / max(high - low, 1e-8), with completed(a) = q(a)
// for a visited child and the mixed value otherwise. Every lane gets the
// node's statistics; `cq` gives the value for one action.
struct MixValue {
  float v_mix, low, span, scale, sum_visits, discount;
  const float* cvis;  // the node's rows of the edge arrays
  const float* crew;
  const float* cval;

  __device__ float completed(int a) const {
    const float q = crew[a] + discount * cval[a];
    return cvis[a] > 0.f ? q : v_mix;
  }
  __device__ float cq(int a) const {
    return scale * ((completed(a) - low) / span);
  }
};

__device__ MixValue mix_value(const Forest& f, int node, int A,
                              float discount, int lane) {
  MixValue m;
  const int row = node * A;
  m.cvis = f.cvis + row;
  m.crew = f.crew + row;
  m.cval = f.cval + row;
  m.discount = discount;
  float sum_visits = 0.f, sum_probs = 0.f, weighted = 0.f, maxvisit = 0.f;
  for (int a = lane; a < A; a += 32) {
    const float cv = m.cvis[a];
    sum_visits += cv;
    maxvisit = fmaxf(maxvisit, cv);
    if (cv > 0.f) {
      const float p = f.cpri[row + a];
      sum_probs += p;
      weighted += p * (m.crew[a] + discount * m.cval[a]);
    }
  }
  sum_visits = warp_sum(sum_visits);
  sum_probs = warp_sum(sum_probs);
  weighted = warp_sum(weighted) / fmaxf(sum_probs, 1e-8f);
  maxvisit = warp_max(maxvisit);
  m.sum_visits = sum_visits;
  m.v_mix = (f.nraw[node] + sum_visits * weighted) / (sum_visits + 1.f);
  float lo = INFINITY, hi = -INFINITY;
  for (int a = lane; a < A; a += 32) {
    const float c = m.completed(a);
    lo = fminf(lo, c);
    hi = fmaxf(hi, c);
  }
  m.low = warp_min(lo);
  m.span = fmaxf(warp_max(hi) - m.low, 1e-8f);
  m.scale = (kMaxvisitInit + maxvisit) * kValueScale;
  return m;
}

// PUCT under the parent-and-siblings qtransform; invalid actions masked at
// depth 0.
__device__ int select_puct(const Forest& f, int cur, int depth, int A,
                           float discount, float pb_c_init, float pb_c_base,
                           const float* inval, int lane) {
  const float nvisit = f.nvis[cur];
  const float nvalue = f.nval[cur];
  const int row = cur * A;
  float lo = INFINITY, hi = -INFINITY;
  for (int a = lane; a < A; a += 32) {
    const float q = f.crew[row + a] + discount * f.cval[row + a];
    const float safe_q = f.cvis[row + a] > 0.f ? q : nvalue;
    lo = fminf(lo, safe_q);
    hi = fmaxf(hi, safe_q);
  }
  const float minv = fminf(nvalue, warp_min(lo));
  const float maxv = fmaxf(nvalue, warp_max(hi));
  const float span = fmaxf(maxv - minv, 1e-8f);
  const float pb_c =
      pb_c_init + logf((nvisit + pb_c_base + 1.f) / pb_c_base);
  const float prior_scale = sqrtf(nvisit) * pb_c;
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = lane; a < A; a += 32) {
    const float cv = f.cvis[row + a];
    const float q = f.crew[row + a] + discount * f.cval[row + a];
    const float completed = cv > 0.f ? q : minv;
    float score =
        (completed - minv) / span + prior_scale * f.cpri[row + a] / (cv + 1.f);
    if (depth == 0 && inval[a] > 0.f) score = kNeg;
    if (score > best) {  // a rises along the lane's stride: first max
      best = score;
      best_a = a;
    }
  }
  return warp_argmax(best, best_a);
}

// Gumbel root: sequential halving over g + logits + sigma(q) among the
// actions whose visits equal the schedule's entry `sched`; the rest, and
// invalid actions, score the finite kNeg.
__device__ int select_gumbel_root(const Forest& f, int A, float discount,
                                  const float* rscore, float sched,
                                  const float* inval, int lane) {
  const MixValue m = mix_value(f, 0, A, discount, lane);
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = lane; a < A; a += 32) {
    float score = f.cvis[a] == sched ? rscore[a] + m.cq(a) : kNeg;
    if (inval[a] > 0.f) score = kNeg;
    if (score > best) {
      best = score;
      best_a = a;
    }
  }
  return warp_argmax(best, best_a);
}

// Gumbel interior: softmax(log prior + sigma(q)) - n / (1 + sum n).
__device__ int select_gumbel_interior(const Forest& f, int cur, int A,
                                      float discount, int lane) {
  const MixValue m = mix_value(f, cur, A, discount, lane);
  const int row = cur * A;
  float mx = -INFINITY;
  for (int a = lane; a < A; a += 32)
    mx = fmaxf(mx, logf(fmaxf(f.cpri[row + a], 1e-30f)) + m.cq(a));
  mx = warp_max(mx);
  float total = 0.f;
  for (int a = lane; a < A; a += 32)
    total += expf(logf(fmaxf(f.cpri[row + a], 1e-30f)) + m.cq(a) - mx);
  total = fmaxf(warp_sum(total), 1e-30f);
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = lane; a < A; a += 32) {
    const float e = expf(logf(fmaxf(f.cpri[row + a], 1e-30f)) + m.cq(a) - mx);
    const float score = e / total - f.cvis[row + a] / (1.f + m.sum_visits);
    if (score > best) {
      best = score;
      best_a = a;
    }
  }
  return warp_argmax(best, best_a);
}

// ---- the tree walk, shared by both kernels --------------------------------

// Resets one environment's forest: node 0 with one visit and the root value,
// every index -1, every statistic 0. The warp's lanes split the arrays.
template <bool kGumbel>
__device__ __forceinline__ void init_forest(const Forest& f, int N, int A,
                                            float rv, int lane) {
  for (int i = lane; i < N; i += 32) {
    f.nvis[i] = i == 0 ? 1.f : 0.f;
    f.nval[i] = i == 0 ? rv : 0.f;
    if (kGumbel) f.nraw[i] = i == 0 ? rv : 0.f;
    f.npar[i] = -1;
    f.nact[i] = -1;
  }
  for (int i = lane; i < N * A; i += 32) {
    f.cidx[i] = -1;
    f.cpri[i] = 0.f;
    f.cvis[i] = 0.f;
    f.crew[i] = 0.f;
    f.cval[i] = 0.f;
  }
}

// One descent from the root to the edge it stops at: an unexpanded child,
// or max_depth. `sched` is this simulation's schedule entry (Gumbel mode).
template <bool kGumbel>
__device__ __forceinline__ void descend(const Forest& f, int A,
                                        float discount, float pb_c_init,
                                        float pb_c_base, int max_depth,
                                        const float* inval,
                                        const float* rscore, float sched,
                                        int lane, int* parent_out,
                                        int* act_out) {
  int cur = 0, parent = -1, act = -1, depth = 0;
  while (true) {
    int best_a;
    if (!kGumbel) {
      best_a = select_puct(f, cur, depth, A, discount, pb_c_init, pb_c_base,
                           inval, lane);
    } else if (depth == 0) {
      best_a = select_gumbel_root(f, A, discount, rscore, sched, inval, lane);
    } else {
      best_a = select_gumbel_interior(f, cur, A, discount, lane);
    }
    const int child = f.cidx[cur * A + best_a];
    parent = cur;
    act = best_a;
    cur = child;
    ++depth;
    if (child < 0 || depth >= max_depth) break;
  }
  *parent_out = parent;
  *act_out = act;
}

// Install of the expanded node (running mean; a re-evaluated node's raw
// value is replaced) and the backup along parent pointers from the raw
// network value, as in the TPU kernel. One lane runs it.
template <bool kGumbel>
__device__ __forceinline__ void install_and_backup(const Forest& f, int A,
                                                   float discount, int slot,
                                                   int parent, int act,
                                                   float value,
                                                   float reward) {
  const int edge = parent * A + act;
  const float count = f.nvis[slot];
  f.nval[slot] = (f.nval[slot] * count + value) / (count + 1.f);
  f.nvis[slot] = count + 1.f;
  if (kGumbel) f.nraw[slot] = value;
  f.npar[slot] = parent;
  f.nact[slot] = act;
  f.crew[edge] = reward;
  f.cidx[edge] = slot;
  int idx = slot;
  float v = value;
  while (idx != 0) {
    const int par = f.npar[idx];
    const int e = par * A + f.nact[idx];
    const float cnt = f.nvis[par];
    const float vnew = f.crew[e] + discount * v;
    f.nval[par] = (f.nval[par] * cnt + vnew) / (cnt + 1.f);
    f.nvis[par] = cnt + 1.f;
    f.cval[e] = f.nval[idx];
    f.cvis[e] += 1.f;
    v = vnew;
    idx = par;
  }
}

// The root summary: visits, value, and r + discount v (MuZero) or the
// completed sigma(q) (Gumbel).
template <bool kGumbel>
__device__ __forceinline__ void write_summary(const Forest& f, int A,
                                              float discount, size_t env,
                                              float* out_visits,
                                              float* out_value, float* out_q,
                                              int lane) {
  if (kGumbel) {
    const MixValue m = mix_value(f, 0, A, discount, lane);
    for (int a = lane; a < A; a += 32) out_q[env * A + a] = m.cq(a);
  } else {
    for (int a = lane; a < A; a += 32)
      out_q[env * A + a] = f.crew[a] + discount * f.cval[a];
  }
  for (int a = lane; a < A; a += 32) out_visits[env * A + a] = f.cvis[a];
  if (lane == 0) out_value[env] = f.nval[0];
}

// ---- MLP modes: one warp per environment, everything in shared memory ----

template <bool kGumbel>
__global__ void __launch_bounds__(32 * kMaxEnvsPerBlock)
fused_search_kernel(const float* __restrict__ root_emb,
                    const float* __restrict__ root_logits,
                    const float* __restrict__ root_value,
                    const float* __restrict__ invalid,
                    const float* __restrict__ root_score,
                    const float* __restrict__ schedule,
                    const float* __restrict__ weights,
                    float* __restrict__ out_visits,
                    float* __restrict__ out_value,
                    float* __restrict__ out_q, const Args args) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < args.n_weights; i += blockDim.x)
    smem[i] = weights[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * args.envs_per_block + warp;
  if (env >= args.B) return;

  const int A = args.A, E = args.E, N = args.num_nodes, NA = N * A;
  const int S41 = args.S41;
  const float discount = args.discount;

  // This environment's forest slice.
  Forest f;
  f.nvis = smem + args.weights_stride + warp * args.env_floats;
  f.nval = f.nvis + N;
  f.npar = reinterpret_cast<int*>(f.nval + N);
  f.nact = f.npar + N;
  f.cidx = f.nact + N;
  f.cpri = reinterpret_cast<float*>(f.cidx + NA);
  f.cvis = f.cpri + NA;
  f.crew = f.cvis + NA;
  f.cval = f.crew + NA;
  float* emb = f.cval + NA;
  float* bufs[2] = {emb + N * E, emb + N * E + args.act_width};
  float* inval = bufs[1] + args.act_width;
  f.nraw = inval + A;         // Gumbel mode: [N]
  float* rscore = f.nraw + N;  // Gumbel mode: [A]

  // ---- forest init ------------------------------------------------------
  init_forest<kGumbel>(f, N, A, root_value[env], lane);
  for (int j = lane; j < E; j += 32)
    emb[j] = root_emb[static_cast<size_t>(env) * E + j];
  for (int a = lane; a < A; a += 32) {
    inval[a] = invalid ? invalid[static_cast<size_t>(env) * A + a] : 0.f;
    if (kGumbel) rscore[a] = root_score[static_cast<size_t>(env) * A + a];
  }
  softmax_into(root_logits + static_cast<size_t>(env) * A, f.cpri, A, lane);

  for (int sim = 0; sim < args.num_simulations; ++sim) {
    // ---- descent ----------------------------------------------------------
    const float sched =
        kGumbel
            ? schedule[static_cast<size_t>(env) * args.num_simulations + sim]
            : 0.f;
    int parent, act;
    descend<kGumbel>(f, A, discount, args.pb_c_init, args.pb_c_base,
                     args.max_depth, inval, rscore, sched, lane, &parent,
                     &act);
    // Fresh node sim+1, unless the depth cap stopped on an existing child.
    const int existing = f.cidx[parent * A + act];
    const int slot = existing < 0 ? sim + 1 : existing;

    // ---- expansion: dynamics on concat(s, one_hot(a)), then prediction --
    for (int j = lane; j < E + A; j += 32)
      bufs[0][j] = j < E ? emb[parent * E + j] : (j - E == act ? 1.f : 0.f);
    __syncwarp();
    const float* p = smem;
    int k = 1, h_width;
    const float* h = run_hidden(p, bufs[0], E + A, args.dyn_width, args.n_dyn,
                                bufs, &k, &h_width, lane);
    dense(p, p + h_width * S41, h, bufs[k], h_width, S41, false, lane);
    p += h_width * S41 + S41;
    const float reward = decode_support(bufs[k], S41, args.support_size, lane);
    dense(p, p + h_width * E, h, bufs[k], h_width, E, false, lane);
    float lo = INFINITY, hi = -INFINITY;
    for (int j = lane; j < E; j += 32) {
      lo = fminf(lo, bufs[k][j]);
      hi = fmaxf(hi, bufs[k][j]);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    const float ns_span = fmaxf(hi - lo, 1e-8f);
    float* ns = emb + slot * E;
    for (int j = lane; j < E; j += 32) ns[j] = (bufs[k][j] - lo) / ns_span;
    __syncwarp();

    p = smem + args.pred_offset;
    k = 0;
    const float* g = run_hidden(p, ns, E, args.pred_width, args.n_pred, bufs,
                                &k, &h_width, lane);
    dense(p, p + h_width * S41, g, bufs[k], h_width, S41, false, lane);
    p += h_width * S41 + S41;
    const float value = decode_support(bufs[k], S41, args.support_size, lane);
    dense(p, p + h_width * A, g, bufs[k], h_width, A, false, lane);
    softmax_into(bufs[k], f.cpri + slot * A, A, lane);

    // ---- install (running mean) and backup along parent pointers -------
    if (lane == 0)
      install_and_backup<kGumbel>(f, A, discount, slot, parent, act, value,
                                  reward);
    __syncwarp();
  }

  write_summary<kGumbel>(f, A, discount, static_cast<size_t>(env),
                         out_visits, out_value, out_q, lane);
}

// ---- categorical modes: a tile of environments per block ------------------
//
// The towers of the categorical family (about 338 K weights at the widths of
// bench.py's muzero_categorical) cannot stay in shared memory, so this kernel
// turns the expansion around: a block owns kTileEnvs environments, its warps
// walk their trees (kept in device memory, where L1 and L2 hold them), and
// after a block-wide barrier every environment of the tile expands at once,
// layer by layer, as one [tile, in] x [in, out] product whose weight chunks
// are read from device memory (L2-resident) once per tile (tile_gemm.cuh).
// Each layer's epilogue (ELU, or LayerNorm then tanh), the decodes, the
// next-state normaliser and the policy softmax run one warp per environment.

constexpr int kTileEnvs = 16;
constexpr int kTileWarps = mz_tile::kThreads / 32;

struct TiledArgs {
  int B, A, E, bins, support, linear;
  float vmin, bin_step;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dyn, n_pred;
  int dyn_width[kMaxLayers], dyn_kind[kMaxLayers], dyn_off[kMaxLayers];
  int pred_width[kMaxLayers], pred_kind[kMaxLayers], pred_off[kMaxLayers];
  int reward_off, state_off, value_off, policy_off;
  int ld;           // floats per activation row
  long env_floats;  // floats of device scratch per environment
};

// The forest of environment `env` in the device scratch.
__device__ __forceinline__ Forest tiled_forest(float* scratch, int env,
                                               const TiledArgs& g,
                                               float** emb) {
  const int N = g.num_nodes, NA = N * g.A;
  float* base = scratch + env * g.env_floats;
  Forest f;
  f.nvis = base;
  f.nval = base + N;
  f.nraw = base + 2 * N;
  f.npar = reinterpret_cast<int*>(base + 3 * N);
  f.nact = reinterpret_cast<int*>(base + 4 * N);
  f.cidx = reinterpret_cast<int*>(base + 5 * N);
  f.cpri = base + 5 * N + NA;
  f.cvis = base + 5 * N + 2 * NA;
  f.crew = base + 5 * N + 3 * NA;
  f.cval = base + 5 * N + 4 * NA;
  *emb = base + 5 * N + 5 * NA;
  return f;
}

// softmax over a row of n logits (overwritten) and its expectation over the
// bins: vmin + j * step (linear), or j - S then h^-1. Every lane returns it.
__device__ float decode_row(float* logits, int n, const TiledArgs& g,
                            int lane) {
  if (!g.linear) return decode_support(logits, n, g.support, lane);
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
    x += (logits[j] / s) * (g.vmin + static_cast<float>(j) * g.bin_step);
  x = warp_sum(x);
  __syncwarp();
  return x;
}

// A hidden layer's epilogue on one row of `out` pre-activations: ELU, or
// LayerNorm (eps 1e-5, scale, offset) then tanh.
__device__ void finish_row(float* y, int out, int kind, const float* scale,
                           const float* offset, int lane) {
  if (kind == 0) {
    for (int j = lane; j < out; j += 32) y[j] = elu(y[j]);
  } else {
    float s = 0.f;
    for (int j = lane; j < out; j += 32) s += y[j];
    const float mean = warp_sum(s) / static_cast<float>(out);
    float v = 0.f;
    for (int j = lane; j < out; j += 32) {
      const float d = y[j] - mean;
      v += d * d;
    }
    const float inv =
        rsqrtf(warp_sum(v) / static_cast<float>(out) + 1e-5f);
    for (int j = lane; j < out; j += 32)
      y[j] = tanhf((y[j] - mean) * inv * scale[j] + offset[j]);
  }
  __syncwarp();
}

// The hidden layers of one tower over the tile: x (rows of width `in`) into
// the other buffer and back. Returns the buffer holding the last layer's
// activations and leaves its width in *width.
__device__ float* tile_tower(const float* weights, const int* offs,
                             const int* widths, const int* kinds, int n,
                             int in, float* x, float* other,
                             const TiledArgs& g, float* gsm, int warp,
                             int lane, int* width) {
  for (int l = 0; l < n; ++l) {
    const int out = widths[l];
    const float* W = weights + offs[l];
    const float* b = W + in * out;
    mz_tile::gemm(kTileEnvs, out, in, x, g.ld, 1, W, out, 1, other, g.ld, 1,
                  b, false, gsm);
    __syncthreads();
    for (int i = warp; i < kTileEnvs; i += kTileWarps)
      finish_row(other + i * g.ld, out, kinds[l], b + out, b + 2 * out,
                 lane);
    __syncthreads();
    float* t = x;
    x = other;
    other = t;
    in = out;
  }
  *width = in;
  return x;
}

template <bool kGumbel>
__global__ void __launch_bounds__(mz_tile::kThreads)
fused_search_tiled_kernel(const float* __restrict__ root_emb,
                          const float* __restrict__ root_logits,
                          const float* __restrict__ root_value,
                          const float* __restrict__ invalid,
                          const float* __restrict__ root_score,
                          const float* __restrict__ schedule,
                          const float* __restrict__ weights,
                          float* __restrict__ scratch,
                          float* __restrict__ out_visits,
                          float* __restrict__ out_value,
                          float* __restrict__ out_q, const TiledArgs g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int T = kTileEnvs;
  float* gsm = smem;
  float* bufs[2] = {smem + mz_tile::kSmemFloats,
                    smem + mz_tile::kSmemFloats + T * g.ld};
  float* inval = bufs[1] + T * g.ld;  // [T, A]
  int* s_parent = reinterpret_cast<int*>(inval + T * g.A);
  int* s_act = s_parent + T;
  int* s_slot = s_act + T;
  float* s_reward = reinterpret_cast<float*>(s_slot + T);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int A = g.A, E = g.E, N = g.num_nodes, bins = g.bins;
  const int env0 = blockIdx.x * T;

  for (int i = warp; i < T; i += kTileWarps) {
    const int env = env0 + i;
    for (int a = lane; a < A; a += 32)
      inval[i * A + a] =
          (env < g.B && invalid) ? invalid[static_cast<size_t>(env) * A + a]
                                 : 0.f;
    if (env >= g.B) continue;
    float* emb;
    const Forest f = tiled_forest(scratch, env, g, &emb);
    init_forest<kGumbel>(f, N, A, root_value[env], lane);
    for (int j = lane; j < E; j += 32)
      emb[j] = root_emb[static_cast<size_t>(env) * E + j];
    softmax_into(root_logits + static_cast<size_t>(env) * A, f.cpri, A,
                 lane);
  }

  for (int sim = 0; sim < g.num_simulations; ++sim) {
    // ---- descent, and the dynamics input concat(s, one_hot(a)) ----------
    for (int i = warp; i < T; i += kTileWarps) {
      const int env = env0 + i;
      float* x = bufs[0] + i * g.ld;
      if (env >= g.B) {
        for (int j = lane; j < E + A; j += 32) x[j] = 0.f;
        if (lane == 0) s_slot[i] = -1;
        continue;
      }
      float* emb;
      const Forest f = tiled_forest(scratch, env, g, &emb);
      const float sched =
          kGumbel ? schedule[static_cast<size_t>(env) * g.num_simulations +
                             sim]
                  : 0.f;
      int parent, act;
      descend<kGumbel>(f, A, g.discount, g.pb_c_init, g.pb_c_base,
                       g.max_depth, inval + i * A,
                       kGumbel ? root_score + static_cast<size_t>(env) * A
                               : nullptr,
                       sched, lane, &parent, &act);
      const int existing = f.cidx[parent * A + act];
      for (int j = lane; j < E + A; j += 32)
        x[j] = j < E ? emb[parent * E + j] : (j - E == act ? 1.f : 0.f);
      if (lane == 0) {
        s_parent[i] = parent;
        s_act[i] = act;
        s_slot[i] = existing < 0 ? sim + 1 : existing;
      }
    }
    __syncthreads();

    // ---- dynamics: hidden layers, reward head, next-state head ----------
    int hw;
    float* h = tile_tower(weights, g.dyn_off, g.dyn_width, g.dyn_kind,
                          g.n_dyn, E + A, bufs[0], bufs[1], g, gsm, warp,
                          lane, &hw);
    float* y = h == bufs[0] ? bufs[1] : bufs[0];
    const float* W = weights + g.reward_off;
    mz_tile::gemm(T, bins, hw, h, g.ld, 1, W, bins, 1, y, g.ld, 1,
                  W + hw * bins, false, gsm);
    __syncthreads();
    for (int i = warp; i < T; i += kTileWarps) {
      const float r = decode_row(y + i * g.ld, bins, g, lane);
      if (lane == 0) s_reward[i] = r;
    }
    __syncthreads();
    W = weights + g.state_off;
    mz_tile::gemm(T, E, hw, h, g.ld, 1, W, E, 1, y, g.ld, 1, W + hw * E,
                  false, gsm);
    __syncthreads();
    for (int i = warp; i < T; i += kTileWarps) {
      float* ns = y + i * g.ld;
      float lo = INFINITY, hi = -INFINITY;
      for (int j = lane; j < E; j += 32) {
        lo = fminf(lo, ns[j]);
        hi = fmaxf(hi, ns[j]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float span = fmaxf(hi - lo, 1e-8f);
      const int env = env0 + i;
      float* emb = nullptr;
      if (env < g.B) tiled_forest(scratch, env, g, &emb);
      for (int j = lane; j < E; j += 32) {
        ns[j] = (ns[j] - lo) / span;
        if (emb) emb[s_slot[i] * E + j] = ns[j];
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- prediction: hidden layers, value head, policy head -------------
    float* p = tile_tower(weights, g.pred_off, g.pred_width, g.pred_kind,
                          g.n_pred, E, y, h, g, gsm, warp, lane, &hw);
    y = p == bufs[0] ? bufs[1] : bufs[0];
    W = weights + g.value_off;
    mz_tile::gemm(T, bins, hw, p, g.ld, 1, W, bins, 1, y, g.ld, 1,
                  W + hw * bins, false, gsm);
    __syncthreads();
    float value[(T + kTileWarps - 1) / kTileWarps];
    for (int i = warp, r = 0; i < T; i += kTileWarps, ++r)
      value[r] = decode_row(y + i * g.ld, bins, g, lane);
    __syncthreads();
    W = weights + g.policy_off;
    mz_tile::gemm(T, A, hw, p, g.ld, 1, W, A, 1, y, g.ld, 1, W + hw * A,
                  false, gsm);
    __syncthreads();

    // ---- install and backup, one warp per environment --------------------
    for (int i = warp, r = 0; i < T; i += kTileWarps, ++r) {
      const int env = env0 + i;
      if (env >= g.B) continue;
      float* emb;
      const Forest f = tiled_forest(scratch, env, g, &emb);
      const int slot = s_slot[i];
      softmax_into(y + i * g.ld, f.cpri + slot * A, A, lane);
      if (lane == 0)
        install_and_backup<kGumbel>(f, A, g.discount, slot, s_parent[i],
                                    s_act[i], value[r], s_reward[i]);
      __syncwarp();
    }
    __syncthreads();
  }

  for (int i = warp; i < T; i += kTileWarps) {
    const int env = env0 + i;
    if (env >= g.B) continue;
    float* emb;
    const Forest f = tiled_forest(scratch, env, g, &emb);
    write_summary<kGumbel>(f, A, g.discount, static_cast<size_t>(env),
                           out_visits, out_value, out_q, lane);
  }
}

// Sizes the shared memory from `args`' shapes and launches one mode.
template <bool kGumbel>
int launch(Args args, const float* root_emb, const float* root_logits,
           const float* root_value, const float* invalid,
           const float* root_score, const float* schedule,
           const float* weights, float* out_visits, float* out_value,
           float* out_q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int per_block = kMaxEnvsPerBlock;
  while (per_block > 0 &&
         (static_cast<long>(args.weights_stride) +
          static_cast<long>(per_block) * args.env_floats) * 4 > max_smem)
    --per_block;
  if (per_block == 0) return kErrShape;
  args.envs_per_block = per_block;
  const size_t smem =
      (static_cast<size_t>(args.weights_stride) +
       static_cast<size_t>(per_block) * args.env_floats) * sizeof(float);
  err = cudaFuncSetAttribute(fused_search_kernel<kGumbel>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (args.B + per_block - 1) / per_block;
  fused_search_kernel<kGumbel><<<grid, 32 * per_block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      root_emb, root_logits, root_value, invalid, root_score, schedule,
      weights, out_visits, out_value, out_q, args);
  return cudaGetLastError();
}

// Fills `args` from the shapes and the tower widths shared by both modes;
// returns 0, or kErrShape when they do not fit the kernel or the flat
// weight buffer.
int make_args(Args* args, int B, int A, int E, int S41, int support_size,
              int num_simulations, int max_depth, float discount,
              int n_weights, int n_dyn, const int* dyn_width, int n_pred,
              const int* pred_width, bool gumbel) {
  if (n_dyn < 1 || n_dyn > kMaxLayers || n_pred < 1 || n_pred > kMaxLayers ||
      B < 1 || A < 1 || E < 1 || S41 < 1 || num_simulations < 1)
    return kErrShape;
  args->B = B;
  args->A = A;
  args->E = E;
  args->S41 = S41;
  args->support_size = support_size;
  args->num_simulations = num_simulations;
  args->max_depth = max_depth;
  args->num_nodes = num_simulations + 1;
  args->discount = discount;
  args->pb_c_init = 0.f;
  args->pb_c_base = 1.f;
  args->n_dyn = n_dyn;
  args->n_pred = n_pred;
  int act_width = E + A;
  if (S41 > act_width) act_width = S41;
  long dyn_floats = 0;
  int in = E + A;
  for (int l = 0; l < n_dyn; ++l) {
    args->dyn_width[l] = dyn_width[l];
    if (dyn_width[l] > act_width) act_width = dyn_width[l];
    dyn_floats += static_cast<long>(in) * dyn_width[l] + dyn_width[l];
    in = dyn_width[l];
  }
  dyn_floats += static_cast<long>(in) * (S41 + E) + S41 + E;
  long pred_floats = 0;
  in = E;
  for (int l = 0; l < n_pred; ++l) {
    args->pred_width[l] = pred_width[l];
    if (pred_width[l] > act_width) act_width = pred_width[l];
    pred_floats += static_cast<long>(in) * pred_width[l] + pred_width[l];
    in = pred_width[l];
  }
  pred_floats += static_cast<long>(in) * (S41 + A) + S41 + A;
  if (dyn_floats + pred_floats != n_weights) return kErrShape;
  args->pred_offset = static_cast<int>(dyn_floats);
  args->n_weights = n_weights;
  args->weights_stride = (n_weights + 3) / 4 * 4;
  args->act_width = act_width;
  const long N = num_simulations + 1;
  // Node and edge arrays, embeddings, two activation buffers, the invalid
  // mask; the Gumbel mode adds the raw values [N] and the root score [A].
  long floats = 4 * N + 5 * N * A + N * E + 2 * act_width + A;
  if (gumbel) floats += N + A;
  args->env_floats = static_cast<int>(floats);
  return 0;
}


// Sizes the tile's shared memory and launches one categorical mode.
template <bool kGumbel>
int launch_tiled(const TiledArgs& g, const float* root_emb,
                 const float* root_logits, const float* root_value,
                 const float* invalid, const float* root_score,
                 const float* schedule, const float* weights, float* scratch,
                 float* out_visits, float* out_value, float* out_q,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem =
      (static_cast<size_t>(mz_tile::kSmemFloats) +
       2 * static_cast<size_t>(kTileEnvs) * g.ld +
       static_cast<size_t>(kTileEnvs) * g.A + 4 * kTileEnvs) *
      sizeof(float);
  if (smem > static_cast<size_t>(max_smem)) return kErrShape;
  err = cudaFuncSetAttribute(fused_search_tiled_kernel<kGumbel>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (g.B + kTileEnvs - 1) / kTileEnvs;
  fused_search_tiled_kernel<kGumbel>
      <<<grid, mz_tile::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          root_emb, root_logits, root_value, invalid, root_score, schedule,
          weights, scratch, out_visits, out_value, out_q, g);
  return cudaGetLastError();
}

// Floats of device scratch per environment of the tiled kernel: node arrays
// (visits, values, raw values, parents, actions), edge arrays (children,
// priors, visits, rewards, values) and the embeddings.
long tiled_env_floats(int A, int E, int num_simulations) {
  const long N = num_simulations + 1;
  return 5 * N + 5 * N * A + N * E;
}

}  // namespace

extern "C" {

// Launch the MuZero search on `stream`. Inputs are env-major and contiguous
// f32: root_emb [B, E], root_logits [B, A] (noised and masked), root_value
// [B], invalid [B, A] or NULL; weights is the flat tower buffer (per layer W
// [in, out] then b [out]: dynamics hidden layers, reward head, next-state
// head, then prediction hidden layers, value head, policy head). Outputs:
// visits [B, A], value [B], q [B, A] (r + discount v). Returns a
// cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_muzero_search(const float* root_emb, const float* root_logits,
                           const float* root_value, const float* invalid,
                           const float* weights, int n_weights,
                           float* out_visits, float* out_value, float* out_q,
                           int B, int A, int E, int S41, int support_size,
                           int num_simulations, int max_depth, float discount,
                           float pb_c_init, float pb_c_base, int n_dyn,
                           const int* dyn_width, int n_pred,
                           const int* pred_width, int device, void* stream) {
  Args args;
  const int bad = make_args(&args, B, A, E, S41, support_size,
                            num_simulations, max_depth, discount, n_weights,
                            n_dyn, dyn_width, n_pred, pred_width, false);
  if (bad) return bad;
  args.pb_c_init = pb_c_init;
  args.pb_c_base = pb_c_base;
  return launch<false>(args, root_emb, root_logits, root_value, invalid,
                       nullptr, nullptr, weights, out_visits, out_value,
                       out_q, device, stream);
}

// Launch the Gumbel MuZero search on `stream`. Inputs as
// mz_fused_muzero_search, with root_logits the masked logits (no noise),
// plus root_score [B, A] (gumbel + root_logits) and schedule
// [B, num_simulations] (each row's considered-visit counts, exact integers
// in f32). Outputs: visits [B, A], value [B], q [B, A] (the root's
// completed sigma(q)). Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_gumbel_search(const float* root_emb, const float* root_logits,
                           const float* root_value, const float* invalid,
                           const float* root_score, const float* schedule,
                           const float* weights, int n_weights,
                           float* out_visits, float* out_value, float* out_q,
                           int B, int A, int E, int S41, int support_size,
                           int num_simulations, int max_depth, float discount,
                           int n_dyn, const int* dyn_width, int n_pred,
                           const int* pred_width, int device, void* stream) {
  if (root_score == nullptr || schedule == nullptr) return MZ_ERR_SHAPE;
  Args args;
  const int bad = make_args(&args, B, A, E, S41, support_size,
                            num_simulations, max_depth, discount, n_weights,
                            n_dyn, dyn_width, n_pred, pred_width, true);
  if (bad) return bad;
  return launch<true>(args, root_emb, root_logits, root_value, invalid,
                      root_score, schedule, weights, out_visits, out_value,
                      out_q, device, stream);
}

// Floats of device scratch the tiled (categorical) search needs for B
// environments.
long mz_tiled_scratch_floats(int B, int A, int E, int num_simulations) {
  return static_cast<long>(B) * tiled_env_floats(A, E, num_simulations);
}

// Launch the tiled search (the categorical modes) on `stream`: MuZero when
// root_score and schedule are NULL, Gumbel otherwise (inputs as
// mz_fused_gumbel_search). weights: per hidden layer W [in, out], b [out]
// and, for an ln_tanh layer (kind 1; kind 0 is elu), its LayerNorm scale
// [out] and offset [out]; the dynamics' hidden layers, reward head and
// next-state head, then the prediction's hidden layers, value head and
// policy head. The value convention is linear (vmin + j (vmax - vmin) /
// (bins - 1)) or, with linear = 0, the h-support of `support`. scratch holds
// mz_tiled_scratch_floats(B, A, E, num_simulations) floats. Returns a
// cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_tiled_search(const float* root_emb, const float* root_logits,
                          const float* root_value, const float* invalid,
                          const float* root_score, const float* schedule,
                          const float* weights, int n_weights, float* scratch,
                          long scratch_floats, float* out_visits,
                          float* out_value, float* out_q, int B, int A, int E,
                          int bins, int linear, int support, float vmin,
                          float vmax, int num_simulations, int max_depth,
                          float discount, float pb_c_init, float pb_c_base,
                          int n_dyn, const int* dyn_width,
                          const int* dyn_kind, int n_pred,
                          const int* pred_width, const int* pred_kind,
                          int device, void* stream) {
  if (n_dyn < 1 || n_dyn > kMaxLayers || n_pred < 1 || n_pred > kMaxLayers ||
      B < 1 || A < 1 || E < 1 || bins < 2 || num_simulations < 1 ||
      (root_score == nullptr) != (schedule == nullptr) ||
      scratch_floats < mz_tiled_scratch_floats(B, A, E, num_simulations))
    return kErrShape;
  TiledArgs g;
  g.B = B;
  g.A = A;
  g.E = E;
  g.bins = bins;
  g.support = support;
  g.linear = linear;
  g.vmin = vmin;
  g.bin_step = static_cast<float>((static_cast<double>(vmax) - vmin) /
                                  (bins - 1));
  g.num_simulations = num_simulations;
  g.max_depth = max_depth;
  g.num_nodes = num_simulations + 1;
  g.discount = discount;
  g.pb_c_init = pb_c_init;
  g.pb_c_base = pb_c_base;
  g.n_dyn = n_dyn;
  g.n_pred = n_pred;
  int ld = E + A;
  if (bins > ld) ld = bins;
  long off = 0;
  int in = E + A;
  for (int l = 0; l < n_dyn; ++l) {
    if (dyn_kind[l] != 0 && dyn_kind[l] != 1) return kErrShape;
    g.dyn_width[l] = dyn_width[l];
    g.dyn_kind[l] = dyn_kind[l];
    g.dyn_off[l] = static_cast<int>(off);
    off += static_cast<long>(in) * dyn_width[l] + dyn_width[l] +
           (dyn_kind[l] ? 2 * dyn_width[l] : 0);
    if (dyn_width[l] > ld) ld = dyn_width[l];
    in = dyn_width[l];
  }
  g.reward_off = static_cast<int>(off);
  off += static_cast<long>(in) * bins + bins;
  g.state_off = static_cast<int>(off);
  off += static_cast<long>(in) * E + E;
  in = E;
  for (int l = 0; l < n_pred; ++l) {
    if (pred_kind[l] != 0 && pred_kind[l] != 1) return kErrShape;
    g.pred_width[l] = pred_width[l];
    g.pred_kind[l] = pred_kind[l];
    g.pred_off[l] = static_cast<int>(off);
    off += static_cast<long>(in) * pred_width[l] + pred_width[l] +
           (pred_kind[l] ? 2 * pred_width[l] : 0);
    if (pred_width[l] > ld) ld = pred_width[l];
    in = pred_width[l];
  }
  g.value_off = static_cast<int>(off);
  off += static_cast<long>(in) * bins + bins;
  g.policy_off = static_cast<int>(off);
  off += static_cast<long>(in) * A + A;
  if (off != n_weights) return kErrShape;
  g.ld = (ld + 3) / 4 * 4;
  g.env_floats = tiled_env_floats(A, E, num_simulations);
  if (root_score != nullptr)
    return launch_tiled<true>(g, root_emb, root_logits, root_value, invalid,
                              root_score, schedule, weights, scratch,
                              out_visits, out_value, out_q, device, stream);
  return launch_tiled<false>(g, root_emb, root_logits, root_value, invalid,
                             nullptr, nullptr, weights, scratch, out_visits,
                             out_value, out_q, device, stream);
}

const char* mz_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused search kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
