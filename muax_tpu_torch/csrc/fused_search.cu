// Fused search: every simulation of every environment in one launch, for
// Hopper (sm_90a), in the two policy modes of the TPU kernel, for the MLP
// triplet (fused_search_kernel: a group of lanes per environment over a
// compact tree in shared memory; fused_search_wide_kernel, entry
// mz_fused_wide_search, for towers wider than a block's shared memory:
// tiles of environments sharing every tower read) and for the acme
// categorical family (fused_search_tiled_kernel, entry
// mz_fused_tiled_search: LayerNorm-tanh layers and the linear two-hot
// decode, `decode="linear"` with ln_tanh towers in the TPU kernel). The
// designs of the last two are described at the kernels.
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
// latency-bound shared-memory traffic, not arithmetic, so the card is filled
// by running many environments' chains at once.
//
// What the design does about it. A group of G lanes (a compile-time 4 or
// 32) owns one environment, so a warp walks 32 / G trees at once: the TPU
// kernel's environments on lanes, made Hopper-sized. The group's lanes split
// the actions during selection (shuffle rounds under the group's mask over
// the fewest lanes that cover the actions find the max, ties go to the
// lowest action), the output rows of each dense layer (four chains at a
// time, two in a whole warp), and the 2S+1 bins of the heads (summed in a
// warp's order whatever G, so that every G rounds alike). Every lane takes
// the walk; one lane installs and backs up. The tree is compact: an edge's visits, value and
// reward are its child node's (see Tree), so a node keeps visits, value,
// reward and parent (and the Gumbel mode's raw value) and an edge its child
// index and prior, 4N + 2NA floats in shared memory at an odd stride per
// environment. The embeddings stay beside the
// tree where every environment of the launch still fits the card at once,
// else in a device scratch (B N E floats, 17 MB at 8192 envs, held in L2).
// The tower weights are staged once per block in its shared memory beside
// the environments' slices; towers wider than that (the 2048 example's
// 1.97 MB) take fused_search_wide_kernel. The wrapper's plan
// (search/fused.py `mlp_search_plan`) picks G, the environments per block
// and the embeddings' place from the batch and the card's limits, so that
// every environment is resident in one wave where the shapes allow.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_tile.cuh"
#include "warp_mlp.cuh"
#include "group_mlp.cuh"
#include "wide_tile.cuh"

// Returned when the shapes do not fit the kernel (too many layers, or one
// environment's tree does not fit the shared memory of a block).
#define MZ_ERR_SHAPE (-1)

namespace {

using namespace mz_group;
using namespace mz_warp;
using mz_wide::bulk_copy;
using mz_wide::mbar_expect_tx;
using mz_wide::mbar_fence_init;
using mz_wide::mbar_init;
using mz_wide::mbar_wait;

constexpr int kErrShape = MZ_ERR_SHAPE;
constexpr int kMaxLayers = 8;
// The MLP kernel's blocks: at most 256 threads. A thread of the G = 32
// instance takes at most 64 registers, so that 32 warps fit an SM; one of
// the G = 4 instance at most 128 (16 warps an SM), which its heads' sums in
// a warp's order need to run without spilling, and which costs no warps
// where it is launched: there the trees' shared memory holds an SM to 8.
constexpr int kMlpThreads = 256;
template <int G>
constexpr int kMlpMinBlocks = G == 32 ? 4 : 2;
constexpr float kNeg = -1e30f;
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
  int env_stride;      // floats of shared memory per environment (odd)
  int emb_offset;      // floats: the embeddings' start in an env's slice
  int envs_per_block;  // lane groups of a block
  int smem_emb;        // embeddings in shared memory, else in the scratch
};

// The tree of one environment of the categorical kernel.
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

// ---- the categorical kernel's tree walk ----------------------------------

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

// ---- MLP modes: a group of G lanes per environment over a compact tree ---

// One environment's compact tree. An edge's visits, value and reward are
// those of the child node it leads to (each backup pass counts the edge and
// its child together, the edge's value is set from the child's just after
// the child's changes, the reward is written at each install of the child),
// so the edge keeps only its child index and prior, and an unexpanded edge
// (child -1) reads as zeros.
struct Tree {
  float* nvis;  // [N]
  float* nval;  // [N]
  float* nrew;  // [N] the reward of the edge into the node
  float* nraw;  // [N] the raw network value, Gumbel mode only
  int* npar;    // [N]
  int* cidx;    // [N, A]
  float* cpri;  // [N, A]

  __device__ __forceinline__ float q(int c, float discount) const {
    return nrew[c] + discount * nval[c];
  }
  __device__ __forceinline__ float visits(int c) const {
    return c >= 0 ? nvis[c] : 0.f;
  }
};

// The lanes of a group that the walk's reductions span: the least power of
// two that covers the actions, at most G. Lane l takes the actions
// first, first + span, ... (first = l mod span), so every span of the group
// sees every action once and holds the whole result.
template <int G>
struct Walk {
  Group<G> g;
  int span, first;

  __device__ explicit Walk(int A) {
    span = 1;
    while (span < A && span < G) span <<= 1;
    first = g.lane & (span - 1);
  }
};

// PUCT under the parent-and-siblings qtransform; invalid actions masked at
// depth 0.
template <int G>
__device__ int group_puct(const Walk<G>& w, const Tree& t, int cur,
                          int depth, int A, float discount, float pb_c_init,
                          float pb_c_base, const float* inval) {
  const float nvisit = t.nvis[cur];
  const float nvalue = t.nval[cur];
  const int* kids = t.cidx + cur * A;
  float lo = INFINITY, hi = -INFINITY;
  for (int a = w.first; a < A; a += w.span) {
    const int c = kids[a];
    const float safe_q = c >= 0 ? t.q(c, discount) : nvalue;
    lo = fminf(lo, safe_q);
    hi = fmaxf(hi, safe_q);
  }
  w.g.min_max(&lo, &hi, w.span);
  const float minv = fminf(nvalue, lo);
  const float maxv = fmaxf(nvalue, hi);
  const float span = fmaxf(maxv - minv, 1e-8f);
  const float pb_c =
      pb_c_init + logf((nvisit + pb_c_base + 1.f) / pb_c_base);
  const float prior_scale = sqrtf(nvisit) * pb_c;
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = w.first; a < A; a += w.span) {
    const int c = kids[a];
    const float completed = c >= 0 ? t.q(c, discount) : minv;
    float score = (completed - minv) / span +
                  prior_scale * t.cpri[cur * A + a] / (t.visits(c) + 1.f);
    if (depth == 0 && inval[a] > 0.f) score = kNeg;
    if (score > best) {  // a rises along the lane's stride: first max
      best = score;
      best_a = a;
    }
  }
  return w.g.argmax(best, best_a, w.span);
}

// completed_by_mix_value at one node, once per visit of the node:
// sigma(q)(a) = (50 + max_a n(a)) * 0.1 * (completed(a) - low) /
// max(high - low, 1e-8), completed(a) = q(a) for a visited child and the
// mixed value otherwise. Every lane of the group gets the node's figures.
struct GroupMix {
  float v_mix, low, span, scale, sum_visits;

  __device__ __forceinline__ float completed(const Tree& t, int c,
                                             float discount) const {
    return c >= 0 ? t.q(c, discount) : v_mix;
  }
  __device__ __forceinline__ float cq(float completed) const {
    return scale * ((completed - low) / span);
  }
};

template <int G>
__device__ GroupMix group_mix(const Walk<G>& w, const Tree& t, int node,
                              int A, float discount) {
  const int* kids = t.cidx + node * A;
  float sum_visits = 0.f, sum_probs = 0.f, weighted = 0.f, maxvisit = 0.f;
  for (int a = w.first; a < A; a += w.span) {
    const int c = kids[a];
    if (c >= 0) {
      const float cv = t.nvis[c];
      const float p = t.cpri[node * A + a];
      sum_visits += cv;
      maxvisit = fmaxf(maxvisit, cv);
      sum_probs += p;
      weighted += p * t.q(c, discount);
    }
  }
  for (int o = w.span / 2; o > 0; o >>= 1) {  // three sums, a max at once
    sum_visits += w.g.shfl(sum_visits, o);
    sum_probs += w.g.shfl(sum_probs, o);
    weighted += w.g.shfl(weighted, o);
    maxvisit = fmaxf(maxvisit, w.g.shfl(maxvisit, o));
  }
  GroupMix m;
  weighted = weighted / fmaxf(sum_probs, 1e-8f);
  m.sum_visits = sum_visits;
  m.v_mix = (t.nraw[node] + sum_visits * weighted) / (sum_visits + 1.f);
  float lo = INFINITY, hi = -INFINITY;
  for (int a = w.first; a < A; a += w.span) {
    const float c = m.completed(t, kids[a], discount);
    lo = fminf(lo, c);
    hi = fmaxf(hi, c);
  }
  w.g.min_max(&lo, &hi, w.span);
  m.low = lo;
  m.span = fmaxf(hi - lo, 1e-8f);
  m.scale = (kMaxvisitInit + maxvisit) * kValueScale;
  return m;
}

// Gumbel root: sequential halving over g + logits + sigma(q) among the
// actions whose visits equal the schedule's entry `sched`; the rest, and
// invalid actions, score the finite kNeg.
template <int G>
__device__ int group_gumbel_root(const Walk<G>& w, const Tree& t, int A,
                                 float discount, const float* rscore,
                                 float sched, const float* inval) {
  const GroupMix m = group_mix(w, t, 0, A, discount);
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = w.first; a < A; a += w.span) {
    const int c = t.cidx[a];
    float score = t.visits(c) == sched
                      ? rscore[a] + m.cq(m.completed(t, c, discount))
                      : kNeg;
    if (inval[a] > 0.f) score = kNeg;
    if (score > best) {
      best = score;
      best_a = a;
    }
  }
  return w.g.argmax(best, best_a, w.span);
}

// Gumbel interior: softmax(log prior + sigma(q)) - n / (1 + sum n). Each
// action's log prior + sigma(q) is computed once, into z (the lane's own
// entries of an activation buffer, free during the walk).
template <int G>
__device__ int group_gumbel_interior(const Walk<G>& w, const Tree& t,
                                     int cur, int A, float discount,
                                     float* z) {
  const GroupMix m = group_mix(w, t, cur, A, discount);
  const int* kids = t.cidx + cur * A;
  float mx = -INFINITY;
  for (int a = w.first; a < A; a += w.span) {
    const float v = logf(fmaxf(t.cpri[cur * A + a], 1e-30f)) +
                    m.cq(m.completed(t, kids[a], discount));
    z[a] = v;
    mx = fmaxf(mx, v);
  }
  mx = w.g.max(mx, w.span);
  float total = 0.f;
  for (int a = w.first; a < A; a += w.span) {
    const float e = expf(z[a] - mx);
    z[a] = e;
    total += e;
  }
  total = fmaxf(w.g.sum(total, w.span), 1e-30f);
  float best = -INFINITY;
  int best_a = INT_MAX;
  for (int a = w.first; a < A; a += w.span) {
    const float score =
        z[a] / total - t.visits(kids[a]) / (1.f + m.sum_visits);
    if (score > best) {
      best = score;
      best_a = a;
    }
  }
  return w.g.argmax(best, best_a, w.span);
}

// One descent from the root to the edge it stops at: an unexpanded child,
// or max_depth. Every lane of the group takes the same path.
template <bool kGumbel, int G>
__device__ __forceinline__ void group_descend(
    const Walk<G>& w, const Tree& t, const Args& args, const float* inval,
    const float* rscore, float sched, float* z, int* parent_out,
    int* act_out) {
  const int A = args.A;
  int cur = 0, parent = -1, act = -1, depth = 0;
  while (true) {
    int best_a;
    if (!kGumbel) {
      best_a = group_puct(w, t, cur, depth, A, args.discount, args.pb_c_init,
                          args.pb_c_base, inval);
    } else if (depth == 0) {
      best_a = group_gumbel_root(w, t, A, args.discount, rscore, sched,
                                 inval);
    } else {
      best_a = group_gumbel_interior(w, t, cur, A, args.discount, z);
    }
    const int child = t.cidx[cur * A + best_a];
    parent = cur;
    act = best_a;
    cur = child;
    ++depth;
    if (child < 0 || depth >= args.max_depth) break;
  }
  *parent_out = parent;
  *act_out = act;
}

// Install of the expanded node (running mean; a re-evaluated node's raw
// value is replaced) and the backup along parent pointers from the raw
// network value, as in the TPU kernel; the edges need no update. One lane
// runs it.
template <bool kGumbel>
__device__ __forceinline__ void group_install_backup(const Tree& t, int A,
                                                     float discount, int slot,
                                                     int parent, int act,
                                                     float value,
                                                     float reward) {
  const float count = t.nvis[slot];
  t.nval[slot] = (t.nval[slot] * count + value) / (count + 1.f);
  t.nvis[slot] = count + 1.f;
  if (kGumbel) t.nraw[slot] = value;
  t.npar[slot] = parent;
  t.nrew[slot] = reward;
  t.cidx[parent * A + act] = slot;
  int idx = slot;
  float v = value;
  while (idx != 0) {
    const int par = t.npar[idx];
    const float cnt = t.nvis[par];
    const float vnew = t.nrew[idx] + discount * v;
    t.nval[par] = (t.nval[par] * cnt + vnew) / (cnt + 1.f);
    t.nvis[par] = cnt + 1.f;
    v = vnew;
    idx = par;
  }
}

// Every simulation of one environment per lane group, the compact trees
// (and, where the launch plan keeps them there, the embeddings) in shared
// memory at an odd stride per environment, the towers staged once per
// block in shared memory. (Towers wider than that take the tile kernel
// below, fused_search_wide_kernel.)
template <bool kGumbel, int G>
__global__ void __launch_bounds__(kMlpThreads, kMlpMinBlocks<G>)
fused_search_kernel(const float* __restrict__ root_emb,
                    const float* __restrict__ root_logits,
                    const float* __restrict__ root_value,
                    const float* __restrict__ invalid,
                    const float* __restrict__ root_score,
                    const float* __restrict__ schedule,
                    const float* __restrict__ weights,
                    float* __restrict__ emb_scratch,
                    float* __restrict__ out_visits,
                    float* __restrict__ out_value,
                    float* __restrict__ out_q, const Args args) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < args.n_weights; i += blockDim.x)
    smem[i] = weights[i];
  __syncthreads();
  const float* towers = smem;

  const int local = threadIdx.x / G;
  const int env = blockIdx.x * args.envs_per_block + local;
  if (env >= args.B) return;
  const int A = args.A, E = args.E, N = args.num_nodes, NA = N * A;
  const Walk<G> w(A);
  const Group<G>& g = w.g;
  const int lane = g.lane;
  const int S41 = args.S41;
  const float discount = args.discount;
  const size_t e = static_cast<size_t>(env);

  // This environment's slice (after the staged weights): the tree, two
  // activation buffers,
  // the invalid mask, the Gumbel mode's raw values and root score, and the
  // embeddings here or in the scratch.
  float* base = smem + args.weights_stride + local * args.env_stride;
  Tree t;
  t.nvis = base;
  t.nval = base + N;
  t.nrew = base + 2 * N;
  t.npar = reinterpret_cast<int*>(base + 3 * N);
  t.cidx = reinterpret_cast<int*>(base + 4 * N);
  t.cpri = base + 4 * N + NA;
  float* bufs[2] = {t.cpri + NA, t.cpri + NA + args.act_width};
  float* inval = bufs[1] + args.act_width;
  t.nraw = inval + A;          // Gumbel mode: [N]
  float* rscore = t.nraw + N;  // Gumbel mode: [A]
  float* emb = args.smem_emb ? base + args.emb_offset
                             : emb_scratch + e * N * E;

  // ---- tree init: node 0 with one visit and the root value --------------
  const float rv = root_value[env];
  for (int i = lane; i < N; i += G) {
    t.nvis[i] = i == 0 ? 1.f : 0.f;
    t.nval[i] = i == 0 ? rv : 0.f;
  }
  if (lane == 0) {
    t.nrew[0] = 0.f;
    t.npar[0] = -1;
    if (kGumbel) t.nraw[0] = rv;
  }
  for (int i = lane; i < NA; i += G) t.cidx[i] = -1;
  for (int j = lane; j < E; j += G) emb[j] = root_emb[e * E + j];
  for (int a = lane; a < A; a += G) {
    inval[a] = invalid ? invalid[e * A + a] : 0.f;
    if (kGumbel) rscore[a] = root_score[e * A + a];
  }
  softmax_row(g, root_logits + e * A, t.cpri, A);

  for (int sim = 0; sim < args.num_simulations; ++sim) {
    // ---- descent ----------------------------------------------------------
    const float sched =
        kGumbel ? schedule[e * args.num_simulations + sim] : 0.f;
    int parent, act;
    group_descend<kGumbel, G>(w, t, args, inval, rscore, sched, bufs[0],
                              &parent, &act);
    // Fresh node sim+1, unless the depth cap stopped on an existing child.
    const int existing = t.cidx[parent * A + act];
    const int slot = existing < 0 ? sim + 1 : existing;

    // ---- expansion: dynamics on concat(s, one_hot(a)), then prediction --
    for (int j = lane; j < E; j += G) bufs[0][j] = emb[parent * E + j];
    g.sync();
    const float* p = towers;
    const float* x = bufs[0];
    int in = E, k = 1;
    for (int l = 0; l < args.n_dyn; ++l) {
      const int out = args.dyn_width[l];
      const int rows = l == 0 ? E + A : in;  // the one-hot rows after s
      dense_elu<G>(g, p, p + rows * out, x, bufs[k], in, out,
                         l == 0 ? p + (E + act) * out : nullptr);
      p += rows * out + out;
      x = bufs[k];
      k ^= 1;
      in = out;
    }
    float* ns = bufs[k];  // the reward logits, then the next state
    const float reward = decode_head<G>(g, p, p + in * S41, x, in, S41,
                                              args.support_size, ns);
    p += in * S41 + S41;
    float lo = INFINITY, hi = -INFINITY;
    for_outputs<G>(g, p, p + in * E, x, in, E, nullptr,
                         [&](int j, float v) {
      ns[j] = v;
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    });
    g.min_max(&lo, &hi);
    const float ns_span = fmaxf(hi - lo, 1e-8f);
    for (int j = lane; j < E; j += G) {
      const float v = (ns[j] - lo) / ns_span;
      ns[j] = v;
      emb[slot * E + j] = v;
    }
    g.sync();

    p = towers + args.pred_offset;
    x = ns;
    in = E;
    k ^= 1;  // the dynamics' last hidden buffer is free again
    for (int l = 0; l < args.n_pred; ++l) {
      const int out = args.pred_width[l];
      dense_elu<G>(g, p, p + in * out, x, bufs[k], in, out, nullptr);
      p += in * out + out;
      x = bufs[k];
      k ^= 1;
      in = out;
    }
    const float value = decode_head<G>(g, p, p + in * S41, x, in, S41,
                                             args.support_size, bufs[k]);
    p += in * S41 + S41;
    float* prior = t.cpri + slot * A;
    for_outputs<G>(g, p, p + in * A, x, in, A, nullptr,
                         [&](int a, float v) { prior[a] = v; });
    softmax_row(g, prior, prior, A);

    // ---- install (running mean) and backup along parent pointers -------
    if (lane == 0)
      group_install_backup<kGumbel>(t, A, discount, slot, parent, act, value,
                                    reward);
    g.sync();
  }

  // ---- the root summary: visits, value, and r + discount v (MuZero) or
  // the completed sigma(q) (Gumbel) ---------------------------------------
  if (kGumbel) {
    const GroupMix m = group_mix(w, t, 0, A, discount);
    for (int a = lane; a < A; a += G)
      out_q[e * A + a] = m.cq(m.completed(t, t.cidx[a], discount));
  } else {
    for (int a = lane; a < A; a += G) {
      const int c = t.cidx[a];
      out_q[e * A + a] = c >= 0 ? t.q(c, discount) : 0.f;
    }
  }
  for (int a = lane; a < A; a += G)
    out_visits[e * A + a] = t.visits(t.cidx[a]);
  if (lane == 0) out_value[env] = t.nval[0];
}

// ---- categorical modes: a cluster of blocks per tile of environments ------
//
// The towers of the categorical family (about 338 K weights at the widths of
// bench.py's muzero_categorical) cannot stay in shared memory, so this kernel
// turns the expansion around: a tile of kTileEnvs environments expands at
// once, layer by layer, as one [tile, in] x [in, out] product on the tensor
// cores (tc_tile.cuh, 3xTF32). A tile belongs to a cluster of kC blocks (4,
// or 2 when the batch is large; the wrapper picks). Each block walks the
// trees of kTileEnvs / kC of the tile's environments, one warp per
// environment, with the embeddings in a device scratch and the node and
// edge arrays in its shared memory (kSmemTrees) or, where they do not fit
// there (many simulations or actions), in the device scratch after the
// embeddings; the wrapper picks. It computes a kC-th of every layer's
// output columns for all the tile's rows, reading only that part of the
// weights from L2. It writes its columns into the same buffer of every
// block of the cluster (distributed shared memory); after a cluster barrier
// each block holds whole rows and runs the layer's epilogue (ELU, or
// LayerNorm then tanh), the same in every block. At 512 envs that is 128
// blocks, one per SM; at 2048, 256 blocks, two per SM. The decodes, the
// next-state normaliser, the policy softmax, the install and the backup run
// in the block that walks the environment.
//
// What bounds it: per expansion the towers' 338 K multiply-adds, so 2048
// envs x 64 simulations are 88.6 GFLOP: 1.32 ms at the f32 FMA peak, 0.54 ms
// at the TF32 tensor-core peak taken three times. Its real limit is the
// chain of dependent steps in each simulation (the descent, eight product
// phases at the bench widths, each ended by a cluster barrier, the install
// and the backup), which the blocks of a cluster shorten by splitting every
// product's columns and the walks between them.
//
// A buffer that a block writes into the others in one phase was last read
// there before the barrier that ended the phase before it: the dynamics
// input X0 is read only by the first dynamics layer, the hidden layers
// alternate between D0 and D1, the reward and next-state heads write the
// free one of those and Z, the prediction alternates between the dynamics'
// last layer and the reward buffer, and the value and policy heads write
// the free one of those and Z again.

constexpr int kTileEnvs = 16;  // environments of a tile
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

struct TiledArgs {
  int B, A, E, bins, support, linear;
  float vmin, bin_step;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dyn, n_pred;
  int dyn_width[kMaxLayers], dyn_kind[kMaxLayers], dyn_off[kMaxLayers];
  int pred_width[kMaxLayers], pred_kind[kMaxLayers], pred_off[kMaxLayers];
  int reward_off, state_off, value_off, policy_off;
  // Floats per row of the hidden-layer buffers, of the dynamics input and of
  // the next-state and policy buffer: each 4 more than a multiple of 32.
  int ld, ld_x, ld_z;
  int tree_floats;  // floats of one tree's node and edge arrays
  long tree_base;   // scratch floats before the trees: B N E embeddings
};

// The node and edge arrays of one tree, at `base` in shared memory or in
// the device scratch.
__device__ __forceinline__ Forest tiled_forest(float* base,
                                               const TiledArgs& g) {
  const int N = g.num_nodes, NA = N * g.A;
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

// The columns [c0, c0 + n) of an N-wide layer that block `rank` of a
// cluster of kC computes: chunks of a multiple of 8 columns, the last
// ragged.
template <int kC>
__device__ __forceinline__ void own_columns(int N, int rank, int* c0,
                                            int* n) {
  const int chunk = ((N + kC - 1) / kC + 7) / 8 * 8;
  *c0 = rank * chunk;
  *n = max(0, min(N - *c0, chunk));
}

// out = x W + b for the tile's rows x [kTileEnvs, ldx] (shared memory) and
// W [in, width] (device memory, b [width] after it), this block's columns
// only, written into out [kTileEnvs, ldo] in every block of the cluster.
// The caller ends the phase with a cluster barrier.
template <int kC>
__device__ void cluster_layer(const float* x, int ldx, int in, const float* W,
                              int width, float* out, int ldo, int rank,
                              int warp) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* dst[kC];
#pragma unroll
  for (int r = 0; r < kC; ++r) dst[r] = cluster.map_shared_rank(out, r);
  int c0, n;
  own_columns<kC>(width, rank, &c0, &n);
  const float* Wc = W + c0;
  const float* b = W + static_cast<long>(in) * width + c0;
  mz_tc::product<1, 1, false>(
      kTileEnvs, n, in, x, ldx, 1, Wc, width, 1,
      [&](int m, int j, float v) {
        v += __ldg(b + j);
#pragma unroll
        for (int r = 0; r < kC; ++r) dst[r][m * ldo + c0 + j] = v;
      },
      warp, kTileWarps);
}

// The hidden layers of one tower over the tile's rows, from x (width `in`)
// through bufs[0], bufs[1], bufs[0], ...; each layer's product, a cluster
// barrier, then its epilogue on every row. Returns the buffer holding the
// last layer's activations and leaves its width in *width.
template <int kC>
__device__ float* cluster_tower(const float* weights, const int* offs,
                                const int* widths, const int* kinds, int n,
                                const float* x, int ldx, int in,
                                float* const* bufs, const TiledArgs& g,
                                int rank, int warp, int lane, int* width) {
  namespace cg = cooperative_groups;
  float* y = nullptr;
  for (int l = 0; l < n; ++l) {
    const int out = widths[l];
    const float* W = weights + offs[l];
    const float* b = W + static_cast<long>(in) * out;
    y = bufs[l % 2];
    cluster_layer<kC>(x, ldx, in, W, out, y, g.ld, rank, warp);
    cg::this_cluster().sync();
    for (int i = warp; i < kTileEnvs; i += kTileWarps)
      finish_row(y + i * g.ld, out, kinds[l], b + out, b + 2 * out, lane);
    __syncthreads();
    x = y;
    ldx = g.ld;
    in = out;
  }
  *width = in;
  return y;
}

template <bool kGumbel, int kC, bool kSmemTrees>
__global__ void __launch_bounds__(kTileThreads, 2)
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
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int kRankEnvs = kTileEnvs / kC;
  const int L = kTileEnvs * g.ld;
  float* D[2] = {smem, smem + L};
  float* X0 = smem + 2 * L;     // the dynamics input [kTileEnvs, ld_x]
  // Z: the next state, then the policy logits [kTileEnvs, ld_z].
  float* Z = X0 + kTileEnvs * g.ld_x;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int A = g.A, E = g.E, N = g.num_nodes, bins = g.bins;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = rank * kRankEnvs;  // this block's rows of the tile
  const int env0 = static_cast<int>(blockIdx.x) / kC * kTileEnvs + row0;
  // The block's trees [kRankEnvs, tree_floats].
  float* trees = kSmemTrees ? Z + kTileEnvs * g.ld_z
                            : scratch + g.tree_base +
                                  static_cast<long>(env0) * g.tree_floats;
  float* inval = kSmemTrees ? trees + kRankEnvs * g.tree_floats
                            : Z + kTileEnvs * g.ld_z;  // [kRankEnvs, A]
  int* s_parent = reinterpret_cast<int*>(inval + kRankEnvs * g.A);
  int* s_act = s_parent + kRankEnvs;
  int* s_slot = s_act + kRankEnvs;
  float* s_reward = reinterpret_cast<float*>(s_slot + kRankEnvs);
  float* x0dst[kC];
  for (int r = 0; r < kC; ++r) x0dst[r] = cluster.map_shared_rank(X0, r);

  for (int i = warp; i < kRankEnvs; i += kTileWarps) {
    const int env = env0 + i;
    for (int a = lane; a < A; a += 32)
      inval[i * A + a] =
          (env < g.B && invalid) ? invalid[static_cast<size_t>(env) * A + a]
                                 : 0.f;
    if (env >= g.B) continue;
    float* emb = scratch + static_cast<long>(env) * N * E;
    const Forest f = tiled_forest(trees + i * g.tree_floats, g);
    init_forest<kGumbel>(f, N, A, root_value[env], lane);
    for (int j = lane; j < E; j += 32)
      emb[j] = root_emb[static_cast<size_t>(env) * E + j];
    softmax_into(root_logits + static_cast<size_t>(env) * A, f.cpri, A,
                 lane);
  }
  cluster.sync();  // every block of the cluster runs before any writes

  for (int sim = 0; sim < g.num_simulations; ++sim) {
    // ---- descent, and the dynamics input concat(s, one_hot(a)) ----------
    for (int i = warp; i < kRankEnvs; i += kTileWarps) {
      const int env = env0 + i;
      const int row = (row0 + i) * g.ld_x;
      if (env >= g.B) {
        for (int j = lane; j < E + A; j += 32)
          for (int r = 0; r < kC; ++r) x0dst[r][row + j] = 0.f;
        if (lane == 0) s_slot[i] = -1;
        continue;
      }
      const float* emb = scratch + static_cast<long>(env) * N * E;
      const Forest f = tiled_forest(trees + i * g.tree_floats, g);
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
      for (int j = lane; j < E + A; j += 32) {
        const float v =
            j < E ? emb[parent * E + j] : (j - E == act ? 1.f : 0.f);
        for (int r = 0; r < kC; ++r) x0dst[r][row + j] = v;
      }
      if (lane == 0) {
        s_parent[i] = parent;
        s_act[i] = act;
        s_slot[i] = existing < 0 ? sim + 1 : existing;
      }
    }
    cluster.sync();

    // ---- dynamics: hidden layers, reward head, next-state head ----------
    int hw;
    float* h = cluster_tower<kC>(weights, g.dyn_off, g.dyn_width, g.dyn_kind,
                                 g.n_dyn, X0, g.ld_x, E + A, D, g, rank, warp,
                                 lane, &hw);
    float* Y = h == D[0] ? D[1] : D[0];  // reward logits
    cluster_layer<kC>(h, g.ld, hw, weights + g.reward_off, bins, Y, g.ld,
                      rank, warp);
    cluster_layer<kC>(h, g.ld, hw, weights + g.state_off, E, Z, g.ld_z, rank,
                      warp);
    cluster.sync();
    for (int i = warp; i < kRankEnvs; i += kTileWarps) {
      const float r = decode_row(Y + (row0 + i) * g.ld, bins, g, lane);
      if (lane == 0) s_reward[i] = r;
    }
    for (int i = warp; i < kTileEnvs; i += kTileWarps) {
      float* ns = Z + i * g.ld_z;
      float lo = INFINITY, hi = -INFINITY;
      for (int j = lane; j < E; j += 32) {
        lo = fminf(lo, ns[j]);
        hi = fmaxf(hi, ns[j]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float span = fmaxf(hi - lo, 1e-8f);
      const int local = i - row0;
      const bool mine = local >= 0 && local < kRankEnvs && env0 + local < g.B;
      float* emb =
          mine ? scratch + static_cast<long>(env0 + local) * N * E : nullptr;
      for (int j = lane; j < E; j += 32) {
        ns[j] = (ns[j] - lo) / span;
        if (mine) emb[s_slot[local] * E + j] = ns[j];
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- prediction: hidden layers, value head, policy head -------------
    float* P[2] = {h, Y};
    float* p = cluster_tower<kC>(weights, g.pred_off, g.pred_width,
                                 g.pred_kind, g.n_pred, Z, g.ld_z, E, P, g,
                                 rank, warp, lane, &hw);
    float* V = p == P[0] ? P[1] : P[0];  // value logits
    cluster_layer<kC>(p, g.ld, hw, weights + g.value_off, bins, V, g.ld, rank,
                      warp);
    cluster_layer<kC>(p, g.ld, hw, weights + g.policy_off, A, Z, g.ld_z, rank,
                      warp);
    cluster.sync();

    // ---- install and backup, one warp per environment --------------------
    for (int i = warp; i < kRankEnvs; i += kTileWarps) {
      const int env = env0 + i;
      if (env >= g.B) continue;
      const int row = row0 + i;
      const float value = decode_row(V + row * g.ld, bins, g, lane);
      const Forest f = tiled_forest(trees + i * g.tree_floats, g);
      const int slot = s_slot[i];
      softmax_into(Z + row * g.ld_z, f.cpri + slot * A, A, lane);
      if (lane == 0)
        install_and_backup<kGumbel>(f, A, g.discount, slot, s_parent[i],
                                    s_act[i], value, s_reward[i]);
      __syncwarp();
    }
    __syncthreads();
  }

  for (int i = warp; i < kRankEnvs; i += kTileWarps) {
    const int env = env0 + i;
    if (env >= g.B) continue;
    const Forest f = tiled_forest(trees + i * g.tree_floats, g);
    write_summary<kGumbel>(f, A, g.discount, static_cast<size_t>(env),
                           out_visits, out_value, out_q, lane);
  }
}

// Sizes the shared memory from the launch plan and launches one MLP mode:
// ceil(B / envs_per_block) blocks of envs_per_block groups of G lanes.
using MlpKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*,
                           const Args);

size_t mlp_smem_bytes(const Args& args) {
  return (static_cast<size_t>(args.weights_stride) +
          static_cast<size_t>(args.envs_per_block) * args.env_stride) *
         sizeof(float);
}

template <bool kGumbel>
MlpKernel mlp_kernel(int group) {
  switch (group) {
    case 4: return fused_search_kernel<kGumbel, 4>;
    case 32: return fused_search_kernel<kGumbel, 32>;
    default: return nullptr;
  }
}

MlpKernel mlp_kernel(int gumbel, int group) {
  return gumbel ? mlp_kernel<true>(group) : mlp_kernel<false>(group);
}

int launch(const Args& args, int gumbel, int group, const float* root_emb,
           const float* root_logits, const float* root_value,
           const float* invalid, const float* root_score,
           const float* schedule, const float* weights, float* emb_scratch,
           float* out_visits, float* out_value, float* out_q, int device,
           void* stream) {
  const MlpKernel kernel = mlp_kernel(gumbel, group);
  const int threads = args.envs_per_block * group;
  if (kernel == nullptr || args.envs_per_block < 1 || threads > kMlpThreads ||
      threads % 32 != 0)
    return kErrShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = mlp_smem_bytes(args);
  if (smem > static_cast<size_t>(max_smem)) return kErrShape;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (args.B + args.envs_per_block - 1) / args.envs_per_block;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      root_emb, root_logits, root_value, invalid, root_score, schedule,
      weights, emb_scratch, out_visits, out_value, out_q, args);
  return cudaGetLastError();
}

// Fills `args` from the shapes, the tower widths and the launch plan (G,
// environments per block, embeddings in shared memory or in a scratch of
// scratch_floats); returns 0, or kErrShape when they do not fit the kernel
// or the flat weight buffer.
int make_args(Args* args, int B, int A, int E, int S41, int support_size,
              int num_simulations, int max_depth, float discount,
              int n_weights, int n_dyn, const int* dyn_width, int n_pred,
              const int* pred_width, bool gumbel, int envs_per_block,
              int smem_emb, const float* emb_scratch, long scratch_floats) {
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
  // An activation buffer holds s, a hidden layer, a head's bins, the next
  // state, or the Gumbel interior's per-action scores.
  int act_width = E > A ? E : A;
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
  // The tree (4 N + 2 N A), two activation buffers, the invalid mask; the
  // Gumbel mode adds the raw values [N] and the root score [A]; then the
  // embeddings [N, E] where they stay in shared memory. An odd stride puts
  // the environments of a warp on different banks.
  const long offset = 4 * N + 2 * N * A + 2L * act_width + A +
                      (gumbel ? N + A : 0);
  const long floats = (offset + (smem_emb ? N * E : 0)) | 1;
  if (floats > INT_MAX / kMlpThreads) return kErrShape;
  if (!smem_emb && (emb_scratch == nullptr ||
                    scratch_floats < static_cast<long>(B) * N * E))
    return kErrShape;
  args->emb_offset = static_cast<int>(offset);
  args->env_stride = static_cast<int>(floats);
  args->envs_per_block = envs_per_block;
  args->smem_emb = smem_emb;
  return 0;
}

// Sizes the cluster's shared memory and launches one categorical mode over
// `grid` blocks, in clusters of kC blocks per tile of kTileEnvs
// environments.
template <bool kGumbel, int kC, bool kSmemTrees>
int launch_tiled(const TiledArgs& g, int grid, const float* root_emb,
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
  // D0, D1, X0, Z; the block's trees, invalid mask and per-env slots.
  constexpr int kRankEnvs = kTileEnvs / kC;
  const size_t smem =
      (static_cast<size_t>(kTileEnvs) * (2 * g.ld + g.ld_x + g.ld_z) +
       static_cast<size_t>(kRankEnvs) *
           ((kSmemTrees ? g.tree_floats : 0) + g.A + 4)) *
      sizeof(float);
  if (smem > static_cast<size_t>(max_smem)) return kErrShape;
  auto kernel = fused_search_tiled_kernel<kGumbel, kC, kSmemTrees>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kTileThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, root_emb, root_logits, root_value,
                           invalid, root_score, schedule, weights, scratch,
                           out_visits, out_value, out_q, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Floats of one tree of the tiled kernel: node arrays (visits, values, raw
// values, parents, actions) and edge arrays (children, priors, visits,
// rewards, values).
int tiled_tree_floats(int A, int num_simulations) {
  const int N = num_simulations + 1;
  return 5 * N + 5 * N * A;
}

// ---- wide MLP modes: a cluster of blocks per tile of environments ---------
//
// Towers wider than a block's shared memory (the 2048 example's (256, 256)
// towers with 601-bin heads: 492,278 floats, 1.97 MB) take this kernel, in
// both policies. Its rule: a tile of kT environments shares every read
// of the towers. Each simulation expands the whole tile at once (16 or 48
// environments), phase by phase: the dynamics' hidden layers, one
// phase for both of its heads (the reward logits and the next state side
// by side as the columns of one product), the prediction's hidden layers,
// one phase for the value and policy heads. A phase is one [kT, in] x
// [in, width] product on the tensor cores, 3xTF32 as in tc_tile.cuh, so
// that the sums keep f32 accuracy. A tile belongs to a cluster of kC
// blocks (16 or 4);
// each block computes a kC-th of every phase's columns, for all kT rows,
// and writes them where they are read (distributed shared memory): a hidden
// layer's and the next state's into every block of the cluster, a head's
// logits into the block that walks the environment, which decodes them
// with whole rows. A cluster barrier ends each phase. Each block walks the
// trees of its kT / kC environments, a warp an environment at a time,
// between the products (the categorical kernel's Forest, descent, install
// and backup).
//
// The weights reach a block already cut to its columns: the wrapper packs
// the flat towers once a launch into one run per cluster rank (biases,
// then each phase's [in, nb] slice, zero-padded to whole k-steps and to
// nb, a multiple of 8, columns; search/fused.py `pack_wide_towers`). Where
// a rank's run fits shared memory beside the tile's buffers (16 blocks a
// tile at the 2048 widths: 132 KB a block), one TMA bulk copy stages it at
// the start and it stays for the whole launch (resident towers). Else the
// towers stream: every phase's slice is cut into pieces of kPieceRows rows
// (one TMA bulk copy each, into a ring of `ring` slots, completion on an
// mbarrier a slot); thread 0 issues piece q + ring as soon as every warp
// has released piece q (a second mbarrier a slot), so the copies run ahead
// of the products across phases and simulations, one copy per block for
// all its warps.
//
// A warp owns whole output tiles of 8 columns over all kT rows; where a
// phase has fewer column tiles than warps, the warps split its k-steps as
// well and add their partial sums in a fixed order. No float atomics; every
// sum runs in one order, so that a repeated launch gives the same bits.
//
// What bounds it: per expansion the towers' 492 K multiply-adds, so 64
// boards x 50 simulations are 3.15 GFLOP (0.047 ms at the f32 FMA peak,
// 0.019 ms at the TF32 tensor-core peak taken three times) and 1024
// boards 50.4 GFLOP (0.75 and 0.31 ms). With tiles of 16 at 64 boards the
// launch holds 64 blocks, with resident towers; at 1024 boards tiles of
// 48 over clusters of 4 (88 blocks: the H100 holds 30 clusters of 4 at
// once, too few for 32 tiles of 32) stream 1.97 MB a tile and simulation
// from L2, 2.17 GB a launch. Its real limit is the chain of dependent
// phases of each simulation, each ended by a cluster barrier, and the walks
// between them.

// The node and edge arrays of one tree of the wide kernel (as
// tiled_forest's), at `base`.
__device__ __forceinline__ Forest wide_forest(float* base, int N, int A) {
  const int NA = N * A;
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
  return f;
}

constexpr int kWideWarps = mz_wide::kWarps;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kMaxPhases = 2 * kMaxLayers + 2;
constexpr int kPieceRows = 32;   // weight rows of a streamed piece
constexpr int kMaxRing = 8;      // slots of the ring of pieces
constexpr int kBarrierFloats = 64;  // the mbarriers, at the start
constexpr int kCopyFloats = 8192;   // floats of one staging bulk copy

struct WideArgs {
  int B, A, E, S41, support;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dyn, n_phases, n_pieces;
  // Phase p: its input width `in` (in8 rows in the pack, a multiple of 8),
  // its output width, the columns nb of every block (block r computes
  // [r nb, r nb + nb) of them), its weights' and biases' offsets in a rank's
  // pack, and its first piece in a simulation's sequence.
  int in[kMaxPhases], in8[kMaxPhases], width[kMaxPhases], nb[kMaxPhases];
  int w_off[kMaxPhases], b_off[kMaxPhases], piece0[kMaxPhases + 1];
  int rank_floats;  // floats of one rank's pack: biases, then weights
  int bias_floats;
  int resident;     // the whole pack in shared memory, else a ring
  int ring, slot_floats;
  int smem_trees;   // the trees in shared memory, else in the scratch
  // Floats per row of the hidden, dynamics-input, next-state, head-logit
  // and policy buffers: each 4 more than a multiple of 32.
  int ld, ld_x, ld_z, ld_l, ld_p;
  int tree_floats;
  long tree_base;   // scratch floats before the trees: B N E embeddings
  // Shared memory (floats from its start): the pack (resident) or the
  // biases and the ring, the two hidden buffers, the dynamics input, the
  // next state, the block's head logits and policy logits, the warps'
  // partial sums, the invalid masks, the per-env slots, the trees.
  int s_pack, s_ring, s_d0, s_d1, s_x0, s_z, s_logit, s_pol, s_red,
      s_inval, s_slots, s_trees, smem_floats;
};

// The weight pieces of a launch: piece q = sim n_pieces + i is the i-th of
// a simulation's sequence, phase after phase, each phase's slice in rows
// of kPieceRows.
struct WidePieces {
  const float* pack;  // this rank's pack in device memory
  float* spack;       // the pack (resident) or the biases, in shared memory
  mz_wide::Ring ring;
  long total;         // pieces in the launch

  // Piece q's phase p and index i in it, its rows and its place in the
  // rank's pack.
  __device__ __forceinline__ void locate(const WideArgs& wa, long q, int* p,
                                         int* i) const {
    const int local = static_cast<int>(q % wa.n_pieces);
    int ph = 0;
    while (local >= wa.piece0[ph + 1]) ++ph;
    *p = ph;
    *i = local - wa.piece0[ph];
  }
  __device__ __forceinline__ int rows(const WideArgs& wa, int p,
                                      int i) const {
    return min(kPieceRows, wa.in8[p] - kPieceRows * i);
  }
  __device__ __forceinline__ int offset(const WideArgs& wa, int p,
                                        int i) const {
    return wa.w_off[p] + kPieceRows * i * wa.nb[p];
  }

  // Thread 0: the copy of piece q into its slot, once every warp has
  // released the slot's previous piece.
  __device__ void issue(const WideArgs& wa, long q) const {
    int p, i;
    locate(wa, q, &p, &i);
    ring.issue(q, pack + offset(wa, p, i), 4u * rows(wa, p, i) * wa.nb[p]);
  }

  // Piece i of phase p (sequence number q), in shared memory: waits for
  // its copy where the towers stream.
  __device__ __forceinline__ const float* acquire(const WideArgs& wa, long q,
                                                  int p, int i) const {
    if (wa.resident) return spack + offset(wa, p, i);
    return ring.wait(q);
  }

  // The warp is done with piece q: it releases the slot, and thread 0
  // refills it with piece q + ring.
  __device__ __forceinline__ void release(const WideArgs& wa, long q) const {
    if (wa.resident) return;
    ring.arrive(q);
    if (threadIdx.x == 0 && q + wa.ring < total) issue(wa, q + wa.ring);
    __syncwarp();
  }
};

// What a phase does with its sums: a hidden layer's ELU into every block's
// buffer; the dynamics' heads (the reward logits into the owning block's
// logit rows, the next state into every block); the prediction's heads (the
// value logits and the policy logits into the owning block).
enum WideKind { kWideHidden, kWideDynHeads, kWidePredHeads };

// One phase: acc = X [kT, in] W[:, this block's columns] over the phase's
// pieces (mz_wide::tile_product), the bias added and the sums stored as
// `kind` says; the caller ends it with a cluster barrier. X lies in shared
// memory with rows of ldx floats; columns at or past `in` read 0.
template <int kT, int kC, int kNTW>
__device__ void wide_phase(const WideArgs& wa, const WidePieces& st, int p,
                           long q0, const float* X, int ldx, int kind,
                           float* out, int ldo, float* red, float* logit,
                           float* pol, int rank, int warp, int lane) {
  namespace cg = cooperative_groups;
  constexpr int kRankEnvs = kT / kC;
  const int nbs = wa.nb[p];
  float acc[kT / 16][kNTW][4];
  int ng, groups;
  mz_wide::tile_product<kT, kNTW>(
      X, ldx, wa.in[p], nbs, wa.piece0[p + 1] - wa.piece0[p], wa.in8[p],
      kPieceRows,
      [&](int pi) { return st.acquire(wa, q0 + pi, p, pi); },
      [&](int pi) { st.release(wa, q0 + pi); }, red, acc, &ng, &groups);
  if (warp % mz_wide::k_split(nbs / 8) != 0) return;  // one warp of a split

  cg::cluster_group cluster = cg::this_cluster();
  const float* bias = st.spack + wa.b_off[p];
  const int c0 = rank * nbs, width = wa.width[p], S41 = wa.S41;
  mz_wide::for_owned<kT, kNTW>(acc, ng, groups, nbs / 8, [&](int m, int n,
                                                             float sum) {
    const int col = c0 + n;
    if (col >= width) return;
    const float v = sum + bias[n];
    const int owner = m / kRankEnvs, row = m % kRankEnvs;
    if (kind == kWideHidden) {
      const float y = elu(v);
      for (int r = 0; r < kC; ++r)
        cluster.map_shared_rank(out, r)[m * ldo + col] = y;
    } else if (col < S41) {
      cluster.map_shared_rank(logit, owner)[row * wa.ld_l + col] = v;
    } else if (kind == kWideDynHeads) {
      for (int r = 0; r < kC; ++r)
        cluster.map_shared_rank(out, r)[m * ldo + col - S41] = v;
    } else {
      cluster.map_shared_rank(pol, owner)[row * wa.ld_p + col - S41] = v;
    }
  });
}

template <bool kGumbel, int kT, int kC, int kNTW>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_search_wide_kernel(const float* __restrict__ root_emb,
                         const float* __restrict__ root_logits,
                         const float* __restrict__ root_value,
                         const float* __restrict__ invalid,
                         const float* __restrict__ root_score,
                         const float* __restrict__ schedule,
                         const float* __restrict__ pack,
                         float* __restrict__ scratch,
                         float* __restrict__ out_visits,
                         float* __restrict__ out_value,
                         float* __restrict__ out_q,
                         const __grid_constant__ WideArgs wa) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int kRankEnvs = kT / kC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int A = wa.A, E = wa.E, N = wa.num_nodes;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = rank * kRankEnvs;  // this block's rows of the tile
  const int env0 = static_cast<int>(blockIdx.x) / kC * kT + row0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  WidePieces st;
  st.pack = pack + static_cast<long>(rank) * wa.rank_floats;
  st.spack = smem + wa.s_pack;
  st.ring = {smem + wa.s_ring, bars + 1, bars + 1 + kMaxRing, wa.ring,
             wa.slot_floats};
  st.total = static_cast<long>(wa.num_simulations) * wa.n_pieces;
  float* D[2] = {smem + wa.s_d0, smem + wa.s_d1};
  float* X0 = smem + wa.s_x0;     // the dynamics input [kT, ld_x]
  float* Z = smem + wa.s_z;       // the next state [kT, ld_z]
  float* Lg = smem + wa.s_logit;  // the block's head logits [kRankEnvs, ld_l]
  float* Pl = smem + wa.s_pol;    // its policy logits [kRankEnvs, ld_p]
  float* red = smem + wa.s_red;
  float* inval = smem + wa.s_inval;  // [kRankEnvs, A]
  int* s_parent = reinterpret_cast<int*>(smem + wa.s_slots);
  int* s_act = s_parent + kRankEnvs;
  int* s_slot = s_act + kRankEnvs;
  float* s_reward = reinterpret_cast<float*>(s_slot + kRankEnvs);
  float* trees = wa.smem_trees
                     ? smem + wa.s_trees
                     : scratch + wa.tree_base +
                           static_cast<long>(env0) * wa.tree_floats;

  // ---- staging: the biases, and the towers (resident) or the first pieces
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < wa.ring; ++s) {
      mbar_init(st.ring.full + s, 1);
      mbar_init(st.ring.empty + s, kWideWarps);
    }
    mbar_fence_init();
    const int first = wa.resident ? wa.rank_floats : wa.bias_floats;
    mbar_expect_tx(bars, 4u * first);
    for (int off = 0; off < first; off += kCopyFloats)
      bulk_copy(st.spack + off, st.pack + off,
                4u * min(kCopyFloats, first - off), bars);
    if (!wa.resident)
      for (long q = 0; q < wa.ring && q < st.total; ++q) st.issue(wa, q);
  }
  for (int i = warp; i < kRankEnvs; i += kWideWarps) {
    const int env = env0 + i;
    for (int a = lane; a < A; a += 32)
      inval[i * A + a] =
          (env < wa.B && invalid) ? invalid[static_cast<size_t>(env) * A + a]
                                  : 0.f;
    if (env >= wa.B) continue;
    float* emb = scratch + static_cast<long>(env) * N * E;
    const Forest f = wide_forest(trees + i * wa.tree_floats, N, A);
    init_forest<kGumbel>(f, N, A, root_value[env], lane);
    for (int j = lane; j < E; j += 32)
      emb[j] = root_emb[static_cast<size_t>(env) * E + j];
    softmax_into(root_logits + static_cast<size_t>(env) * A, f.cpri, A,
                 lane);
  }
  cluster.sync();  // the barriers initialised; every block of the cluster runs
  mbar_wait(bars, 0);

  for (int sim = 0; sim < wa.num_simulations; ++sim) {
    // ---- walk: each env's descent, and the dynamics input
    // concat(s, one_hot(a)) into every block of the cluster
    for (int i = warp; i < kRankEnvs; i += kWideWarps) {
      const int env = env0 + i;
      const int row = (row0 + i) * wa.ld_x;
      if (env >= wa.B) {
        for (int j = lane; j < E + A; j += 32)
          for (int r = 0; r < kC; ++r)
            cluster.map_shared_rank(X0, r)[row + j] = 0.f;
        if (lane == 0) s_slot[i] = -1;
        continue;
      }
      const float* emb = scratch + static_cast<long>(env) * N * E;
      const Forest f = wide_forest(trees + i * wa.tree_floats, N, A);
      const float sched =
          kGumbel ? schedule[static_cast<size_t>(env) * wa.num_simulations +
                             sim]
                  : 0.f;
      int parent, act;
      descend<kGumbel>(f, A, wa.discount, wa.pb_c_init, wa.pb_c_base,
                       wa.max_depth, inval + i * A,
                       kGumbel ? root_score + static_cast<size_t>(env) * A
                               : nullptr,
                       sched, lane, &parent, &act);
      const int existing = f.cidx[parent * A + act];
      for (int j = lane; j < E + A; j += 32) {
        const float v =
            j < E ? emb[parent * E + j] : (j - E == act ? 1.f : 0.f);
        for (int r = 0; r < kC; ++r)
          cluster.map_shared_rank(X0, r)[row + j] = v;
      }
      if (lane == 0) {
        s_parent[i] = parent;
        s_act[i] = act;
        s_slot[i] = existing < 0 ? sim + 1 : existing;
      }
    }
    cluster.sync();

    // ---- dynamics: hidden layers, then both heads in one phase
    long q = static_cast<long>(sim) * wa.n_pieces;
    const float* x = X0;
    int ldx = wa.ld_x, buf = 0;
    for (int p = 0; p < wa.n_dyn; ++p) {
      wide_phase<kT, kC, kNTW>(wa, st, p, q, x, ldx, kWideHidden, D[buf],
                               wa.ld, red, Lg, Pl, rank, warp, lane);
      q += wa.piece0[p + 1] - wa.piece0[p];
      cluster.sync();  // the dynamics' layer p is whole in every block
      x = D[buf];
      ldx = wa.ld;
      buf ^= 1;
    }
    wide_phase<kT, kC, kNTW>(wa, st, wa.n_dyn, q, x, ldx, kWideDynHeads, Z,
                             wa.ld_z, red, Lg, Pl, rank, warp, lane);
    q += wa.piece0[wa.n_dyn + 1] - wa.piece0[wa.n_dyn];
    cluster.sync();  // the dynamics' heads are whole where they are read

    // ---- reward decode and the next state's min-max normaliser
    for (int i = warp; i < kRankEnvs; i += kWideWarps) {
      if (env0 + i >= wa.B) continue;
      const float r = decode_support(Lg + i * wa.ld_l, wa.S41, wa.support,
                                     lane);
      if (lane == 0) s_reward[i] = r;
    }
    for (int i = warp; i < kT; i += kWideWarps) {
      float* ns = Z + i * wa.ld_z;
      float lo = INFINITY, hi = -INFINITY;
      for (int j = lane; j < E; j += 32) {
        lo = fminf(lo, ns[j]);
        hi = fmaxf(hi, ns[j]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float span = fmaxf(hi - lo, 1e-8f);
      const int local = i - row0;
      const bool mine =
          local >= 0 && local < kRankEnvs && env0 + local < wa.B;
      float* emb =
          mine ? scratch + static_cast<long>(env0 + local) * N * E : nullptr;
      for (int j = lane; j < E; j += 32) {
        ns[j] = (ns[j] - lo) / span;
        if (mine) emb[s_slot[local] * E + j] = ns[j];
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- prediction: hidden layers, then the value and policy heads
    x = Z;
    ldx = wa.ld_z;
    buf = 0;
    const int p_pred = wa.n_dyn + 1, p_heads = wa.n_phases - 1;
    for (int p = p_pred; p < p_heads; ++p) {
      wide_phase<kT, kC, kNTW>(wa, st, p, q, x, ldx, kWideHidden, D[buf],
                               wa.ld, red, Lg, Pl, rank, warp, lane);
      q += wa.piece0[p + 1] - wa.piece0[p];
      cluster.sync();  // the prediction's layer p is whole in every block
      x = D[buf];
      ldx = wa.ld;
      buf ^= 1;
    }
    wide_phase<kT, kC, kNTW>(wa, st, p_heads, q, x, ldx, kWidePredHeads,
                             nullptr, 0, red, Lg, Pl, rank, warp, lane);
    cluster.sync();  // the prediction's heads are whole where they are read

    // ---- value decode, install and backup, one warp an environment
    for (int i = warp; i < kRankEnvs; i += kWideWarps) {
      const int env = env0 + i;
      if (env >= wa.B) continue;
      const float value = decode_support(Lg + i * wa.ld_l, wa.S41,
                                         wa.support, lane);
      const Forest f = wide_forest(trees + i * wa.tree_floats, N, A);
      const int slot = s_slot[i];
      softmax_into(Pl + i * wa.ld_p, f.cpri + slot * A, A, lane);
      if (lane == 0)
        install_and_backup<kGumbel>(f, A, wa.discount, slot, s_parent[i],
                                    s_act[i], value, s_reward[i]);
      __syncwarp();
    }
  }

  // ---- the root summary of each env
  for (int i = warp; i < kRankEnvs; i += kWideWarps) {
    const int env = env0 + i;
    if (env >= wa.B) continue;
    const Forest f = wide_forest(trees + i * wa.tree_floats, N, A);
    write_summary<kGumbel>(f, A, wa.discount, static_cast<size_t>(env),
                           out_visits, out_value, out_q, lane);
  }
  cluster.sync();  // no block exits while another may still write into it
}

// ---- the wide kernel's launch ---------------------------------------------

// The instances: tile rows kT, blocks kC a cluster, and the column tiles a
// warp can own in a phase (kNTW).
using WideKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, float*, float*, float*, float*,
                            const WideArgs);

template <bool kGumbel>
WideKernel wide_kernel(int tile, int cluster, int* ntw) {
  if (tile == 16 && cluster == 16) {
    *ntw = 1;
    return fused_search_wide_kernel<kGumbel, 16, 16, 1>;
  }
  if (tile == 48 && cluster == 4) {
    *ntw = 3;
    return fused_search_wide_kernel<kGumbel, 48, 4, 3>;
  }
  return nullptr;
}

WideKernel wide_kernel(int gumbel, int tile, int cluster, int* ntw) {
  return gumbel ? wide_kernel<true>(tile, cluster, ntw)
                : wide_kernel<false>(tile, cluster, ntw);
}

// Fills the phases, the pack's layout and the shared memory's from the
// shapes and the plan (tile rows, cluster blocks, the towers resident or
// streamed through `ring` slots, the trees in shared memory or not);
// returns 0, or kErrShape where the plan does not fit the instance (a
// phase with more column tiles than its warps can own) or the limits.
// search/fused.py `wide_layout` repeats the arithmetic for the plan.
int wide_layout(WideArgs* wa, int B, int A, int E, int S41, int support,
                int num_simulations, int n_dyn, const int* dyn_width,
                int n_pred, const int* pred_width, int tile, int cluster,
                int ntw, int resident, int ring, int smem_trees) {
  if (n_dyn < 1 || n_dyn > kMaxLayers || n_pred < 1 || n_pred > kMaxLayers ||
      B < 1 || A < 1 || E < 1 || S41 < 1 || num_simulations < 1 ||
      ring < (resident ? 0 : 2) || ring > kMaxRing)
    return kErrShape;
  wa->B = B;
  wa->A = A;
  wa->E = E;
  wa->S41 = S41;
  wa->support = support;
  wa->num_simulations = num_simulations;
  wa->num_nodes = num_simulations + 1;
  wa->n_dyn = n_dyn;
  wa->n_phases = n_dyn + n_pred + 2;
  int in = E + A, hidden = 1, n = 0;
  auto phase = [&](int width) {
    wa->in[n] = in;
    wa->in8[n] = (in + 7) / 8 * 8;
    wa->width[n] = width;
    wa->nb[n] = ((width + cluster - 1) / cluster + 7) / 8 * 8;
    ++n;
  };
  for (int l = 0; l < n_dyn; ++l) {
    phase(dyn_width[l]);
    in = dyn_width[l];
    if (in > hidden) hidden = in;
  }
  phase(S41 + E);
  in = E;
  for (int l = 0; l < n_pred; ++l) {
    phase(pred_width[l]);
    in = pred_width[l];
    if (in > hidden) hidden = in;
  }
  phase(S41 + A);
  int bias = 0, weights = 0, pieces = 0, slot = 0;
  for (int p = 0; p < n; ++p) {
    if (mz_wide::warp_tiles(wa->nb[p]) > ntw) return kErrShape;
    wa->b_off[p] = bias;
    bias += wa->nb[p];
    wa->piece0[p] = pieces;
    pieces += (wa->in8[p] + kPieceRows - 1) / kPieceRows;
    if (kPieceRows * wa->nb[p] > slot) slot = kPieceRows * wa->nb[p];
  }
  wa->piece0[n] = pieces;
  wa->n_pieces = pieces;
  wa->bias_floats = (bias + 7) / 8 * 8;
  weights = wa->bias_floats;
  for (int p = 0; p < n; ++p) {
    wa->w_off[p] = weights;
    weights += wa->in8[p] * wa->nb[p];
  }
  wa->rank_floats = weights;
  wa->resident = resident;
  wa->ring = resident ? 0 : ring;
  wa->slot_floats = slot;
  wa->smem_trees = smem_trees;
  auto row = [](int k) { return (k + 31) / 32 * 32 + 4; };
  wa->ld = row(hidden);
  wa->ld_x = row(E + A);
  wa->ld_z = row(E);
  wa->ld_l = row(S41);
  wa->ld_p = row(A);
  const int N = num_simulations + 1;
  wa->tree_floats = (5 * N + 5 * N * A + 3) / 4 * 4;
  wa->tree_base = static_cast<long>(B) * N * E;
  const int envs = tile / cluster;
  const long fm = tile / 16;
  long cur = kBarrierFloats;
  auto take = [&](long floats) {
    const long at = cur;
    cur += (floats + 3) / 4 * 4;
    return static_cast<int>(at);
  };
  wa->s_pack = take(resident ? wa->rank_floats : wa->bias_floats);
  wa->s_ring = take(resident ? 0 : static_cast<long>(ring) * slot);
  wa->s_d0 = take(static_cast<long>(tile) * wa->ld);
  wa->s_d1 = take(static_cast<long>(tile) * wa->ld);
  wa->s_x0 = take(static_cast<long>(tile) * wa->ld_x);
  wa->s_z = take(static_cast<long>(tile) * wa->ld_z);
  wa->s_logit = take(static_cast<long>(envs) * wa->ld_l);
  wa->s_pol = take(static_cast<long>(envs) * wa->ld_p);
  wa->s_red = take(kWideWarps * fm * 128);
  wa->s_inval = take(static_cast<long>(envs) * A);
  wa->s_slots = take(4L * envs);
  wa->s_trees = take(smem_trees ? static_cast<long>(envs) * wa->tree_floats
                                : 0);
  if (cur > INT_MAX / 4) return kErrShape;
  wa->smem_floats = static_cast<int>(cur);
  return 0;
}

// Sets the wide kernel's attributes for `smem` bytes of shared memory and
// fills a launch configuration of `grid` blocks in clusters of `cluster`.
int wide_config(WideKernel kernel, int cluster, size_t smem, int grid,
                cudaStream_t stream, cudaLaunchConfig_t* config,
                cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *config = {};
  config->gridDim = dim3(grid);
  config->blockDim = dim3(kWideThreads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return 0;
}

// The launch of one wide mode over ceil(B / tile) clusters.
int launch_wide(const WideArgs& wa, int gumbel, int tile, int cluster,
                const float* root_emb, const float* root_logits,
                const float* root_value, const float* invalid,
                const float* root_score, const float* schedule,
                const float* pack, float* scratch, float* out_visits,
                float* out_value, float* out_q, int device, void* stream) {
  int ntw = 0;
  const WideKernel kernel = wide_kernel(gumbel, tile, cluster, &ntw);
  if (kernel == nullptr) return kErrShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(wa.smem_floats) * sizeof(float);
  if (smem > static_cast<size_t>(max_smem)) return kErrShape;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const int bad = wide_config(kernel, cluster, smem,
                              (wa.B + tile - 1) / tile * cluster,
                              static_cast<cudaStream_t>(stream), &config,
                              &attr);
  if (bad) return bad;
  err = cudaLaunchKernelEx(&config, kernel, root_emb, root_logits, root_value,
                           invalid, root_score, schedule, pack, scratch,
                           out_visits, out_value, out_q, wa);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the MuZero search on `stream`. Inputs are env-major and contiguous
// f32: root_emb [B, E], root_logits [B, A] (noised and masked), root_value
// [B], invalid [B, A] or NULL; weights is the flat tower buffer (per layer W
// [in, out] then b [out]: dynamics hidden layers, reward head, next-state
// head, then prediction hidden layers, value head, policy head). The launch
// plan: `group` lanes per environment (4 or 32), envs_per_block
// groups a block (envs_per_block x group a multiple of 32, at most 256),
// the embeddings in shared memory (smem_emb) or in emb_scratch, B N E
// floats, N = num_simulations + 1; the towers are staged in each block's
// shared memory. Outputs: visits [B, A], value [B], q [B, A] (r + discount
// v). Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_muzero_search(const float* root_emb, const float* root_logits,
                           const float* root_value, const float* invalid,
                           const float* weights, int n_weights,
                           float* emb_scratch, long scratch_floats, int group,
                           int envs_per_block, int smem_emb,
                           float* out_visits, float* out_value, float* out_q,
                           int B, int A, int E, int S41, int support_size,
                           int num_simulations, int max_depth, float discount,
                           float pb_c_init, float pb_c_base, int n_dyn,
                           const int* dyn_width, int n_pred,
                           const int* pred_width, int device, void* stream) {
  Args args;
  const int bad = make_args(&args, B, A, E, S41, support_size,
                            num_simulations, max_depth, discount, n_weights,
                            n_dyn, dyn_width, n_pred, pred_width, false,
                            envs_per_block, smem_emb, emb_scratch,
                            scratch_floats);
  if (bad) return bad;
  args.pb_c_init = pb_c_init;
  args.pb_c_base = pb_c_base;
  return launch(args, 0, group, root_emb, root_logits, root_value, invalid,
                nullptr, nullptr, weights, emb_scratch, out_visits, out_value,
                out_q, device, stream);
}

// Launch the Gumbel MuZero search on `stream`. Inputs and plan as
// mz_fused_muzero_search, with root_logits the masked logits (no noise),
// plus root_score [B, A] (gumbel + root_logits) and schedule
// [B, num_simulations] (each row's considered-visit counts, exact integers
// in f32). Outputs: visits [B, A], value [B], q [B, A] (the root's
// completed sigma(q)). Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_gumbel_search(const float* root_emb, const float* root_logits,
                           const float* root_value, const float* invalid,
                           const float* root_score, const float* schedule,
                           const float* weights, int n_weights,
                           float* emb_scratch, long scratch_floats, int group,
                           int envs_per_block, int smem_emb,
                           float* out_visits, float* out_value, float* out_q,
                           int B, int A, int E, int S41, int support_size,
                           int num_simulations, int max_depth, float discount,
                           int n_dyn, const int* dyn_width, int n_pred,
                           const int* pred_width, int device, void* stream) {
  if (root_score == nullptr || schedule == nullptr) return MZ_ERR_SHAPE;
  Args args;
  const int bad = make_args(&args, B, A, E, S41, support_size,
                            num_simulations, max_depth, discount, n_weights,
                            n_dyn, dyn_width, n_pred, pred_width, true,
                            envs_per_block, smem_emb, emb_scratch,
                            scratch_floats);
  if (bad) return bad;
  return launch(args, 1, group, root_emb, root_logits, root_value, invalid,
                root_score, schedule, weights, emb_scratch, out_visits,
                out_value, out_q, device, stream);
}

// Blocks of the MLP kernel (mode `gumbel`, G = group) of `threads` threads
// and smem_bytes of dynamic shared memory that one SM holds at once, as the
// CUDA runtime reckons it from the compiled kernel; into *out.
int mz_mlp_blocks_per_sm(int gumbel, int group, int threads, long smem_bytes,
                         int device, int* out) {
  const MlpKernel kernel = mlp_kernel(gumbel, group);
  if (kernel == nullptr) return kErrShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, threads, static_cast<size_t>(smem_bytes));
}

// Launch the tiled search (the categorical modes) on `stream`: MuZero when
// root_score and schedule are NULL, Gumbel otherwise (inputs as
// mz_fused_gumbel_search). weights: per hidden layer W [in, out], b [out]
// and, for an ln_tanh layer (kind 1; kind 0 is elu), its LayerNorm scale
// [out] and offset [out]; the dynamics' hidden layers, reward head and
// next-state head, then the prediction's hidden layers, value head and
// policy head. The value convention is linear (vmin + j (vmax - vmin) /
// (bins - 1)) or, with linear = 0, the h-support of `support`. scratch holds
// the trees' embeddings, B N E floats, N = num_simulations + 1, and, unless
// smem_trees, their node and edge arrays after them, B (5 N + 5 N A)
// floats; each tile of 16 environments runs on a cluster of `cluster`
// blocks (2 or 4), and grid is cluster ceil(B / 16) blocks. Returns a
// cudaError_t, or MZ_ERR_SHAPE (also when the shared memory a block needs
// passes the device's limit).
int mz_fused_tiled_search(const float* root_emb, const float* root_logits,
                          const float* root_value, const float* invalid,
                          const float* root_score, const float* schedule,
                          const float* weights, int n_weights, float* scratch,
                          long scratch_floats, int cluster, int smem_trees,
                          int grid, float* out_visits,
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
      (cluster != 2 && cluster != 4) ||
      grid != (B + kTileEnvs - 1) / kTileEnvs * cluster)
    return kErrShape;
  const long tree_base = static_cast<long>(B) * (num_simulations + 1) * E;
  const long tree_floats = tiled_tree_floats(A, num_simulations);
  if (scratch_floats < tree_base + (smem_trees ? 0 : B * tree_floats))
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
  int ld = bins;
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
  // Rows 4 floats longer than a multiple of 32: conflict-free A fragments.
  auto row = [](int n) { return (n + 31) / 32 * 32 + 4; };
  g.ld = row(ld);
  g.ld_x = row(E + A);
  g.ld_z = row(E > A ? E : A);
  g.tree_floats = static_cast<int>(tree_floats);
  g.tree_base = tree_base;
  auto go = [&](auto launch) {
    return launch(g, grid, root_emb, root_logits, root_value, invalid,
                  root_score, schedule, weights, scratch, out_visits,
                  out_value, out_q, device, stream);
  };
  auto trees = [&](auto in_smem, auto in_scratch) {
    return smem_trees ? go(in_smem) : go(in_scratch);
  };
  if (root_score != nullptr)
    return cluster == 2
               ? trees(launch_tiled<true, 2, true>, launch_tiled<true, 2, false>)
               : trees(launch_tiled<true, 4, true>,
                       launch_tiled<true, 4, false>);
  return cluster == 2
             ? trees(launch_tiled<false, 2, true>, launch_tiled<false, 2, false>)
             : trees(launch_tiled<false, 4, true>,
                     launch_tiled<false, 4, false>);
}

// Launch a wide mode (towers wider than a block's shared memory): MuZero
// when root_score and schedule are NULL, Gumbel otherwise (inputs as
// mz_fused_gumbel_search). pack: the towers cut by columns for each of the
// `cluster` ranks (search/fused.py `pack_wide_towers`; pack_floats =
// cluster x mz_wide_layout's out[1]); scratch: the trees' embeddings, B N E
// floats, N = num_simulations + 1, then, unless smem_trees, their node and
// edge arrays. The plan: tiles of `tile` envs on clusters of `cluster`
// blocks (16 x 16 or 48 x 4), the towers resident in shared memory or
// streamed through `ring` slots. Outputs as mz_fused_muzero_search or
// mz_fused_gumbel_search. Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_wide_search(const float* root_emb, const float* root_logits,
                         const float* root_value, const float* invalid,
                         const float* root_score, const float* schedule,
                         const float* pack, long pack_floats, float* scratch,
                         long scratch_floats, int tile, int cluster,
                         int resident, int ring, int smem_trees,
                         float* out_visits, float* out_value, float* out_q,
                         int B, int A, int E, int S41, int support_size,
                         int num_simulations, int max_depth, float discount,
                         float pb_c_init, float pb_c_base, int n_dyn,
                         const int* dyn_width, int n_pred,
                         const int* pred_width, int device, void* stream) {
  if ((root_score == nullptr) != (schedule == nullptr)) return MZ_ERR_SHAPE;
  int ntw = 0;
  if (wide_kernel(0, tile, cluster, &ntw) == nullptr) return MZ_ERR_SHAPE;
  WideArgs wa;
  const int bad = wide_layout(&wa, B, A, E, S41, support_size,
                              num_simulations, n_dyn, dyn_width, n_pred,
                              pred_width, tile, cluster, ntw, resident, ring,
                              smem_trees);
  if (bad) return bad;
  if (pack_floats != static_cast<long>(cluster) * wa.rank_floats ||
      scratch_floats <
          wa.tree_base +
              (smem_trees ? 0 : static_cast<long>(B) * wa.tree_floats))
    return MZ_ERR_SHAPE;
  wa.max_depth = max_depth;
  wa.discount = discount;
  wa.pb_c_init = pb_c_init;
  wa.pb_c_base = pb_c_base;
  return launch_wide(wa, root_score != nullptr, tile, cluster, root_emb,
                     root_logits, root_value, invalid, root_score, schedule,
                     pack, scratch, out_visits, out_value, out_q, device,
                     stream);
}

// The wide kernel's layout for the plan (arguments as mz_fused_wide_search):
// out = {shared memory bytes a block, floats of a rank's pack, floats of
// its biases, pieces a simulation, floats of a ring slot}.
int mz_wide_layout(int B, int A, int E, int S41, int num_simulations,
                   int n_dyn, const int* dyn_width, int n_pred,
                   const int* pred_width, int tile, int cluster, int resident,
                   int ring, int smem_trees, long* out) {
  int ntw = 0;
  if (wide_kernel(0, tile, cluster, &ntw) == nullptr) return MZ_ERR_SHAPE;
  WideArgs wa;
  const int bad = wide_layout(&wa, B, A, E, S41, 0, num_simulations, n_dyn,
                              dyn_width, n_pred, pred_width, tile, cluster,
                              ntw, resident, ring, smem_trees);
  if (bad) return bad;
  out[0] = 4L * wa.smem_floats;
  out[1] = wa.rank_floats;
  out[2] = wa.bias_floats;
  out[3] = wa.n_pieces;
  out[4] = wa.slot_floats;
  return 0;
}

// Clusters of the wide kernel (mode `gumbel`, tile rows x cluster blocks,
// smem_bytes of shared memory a block) that the card holds at once, as the
// CUDA runtime reckons it (cudaOccupancyMaxActiveClusters); into *out.
int mz_wide_active_clusters(int gumbel, int tile, int cluster,
                            long smem_bytes, int device, int* out) {
  int ntw = 0;
  const WideKernel kernel = wide_kernel(gumbel, tile, cluster, &ntw);
  if (kernel == nullptr) return MZ_ERR_SHAPE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const int bad = wide_config(kernel, cluster, static_cast<size_t>(smem_bytes),
                              cluster, nullptr, &config, &attr);
  if (bad) return bad;
  return cudaOccupancyMaxActiveClusters(out, kernel, &config);
}

// The limits the wrapper sizes the searches' launches by: SMs, shared
// memory per SM, per block (opt-in) and reserved per block, in bytes, and
// 32-bit registers per SM.
int mz_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return err;
  }
  return 0;
}

const char* mz_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused search kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
