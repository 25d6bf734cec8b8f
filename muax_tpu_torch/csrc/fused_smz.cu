// Stochastic MuZero forest search: every simulation of every environment in
// one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel muax_tpu/search/fused.py `_make_smz_kernel`, which
// `fused_smz_search` launches through pl.pallas_call
// (muax_tpu/search/fused.py:1369). The plain PyTorch version of the same
// function is `fused_smz_search_reference` in muax_tpu_torch/search/fused.py.
//
// What it computes. A forest over the extended action space A' = A + C. A
// node created by a chance outcome (slot >= A), and the root, is a decision
// node; every other node is a chance node (an afterstate). Per simulation:
// descend from the root (decision nodes: PUCT over their A slots under the
// parent-and-siblings qtransform, q = r + gamma v; chance nodes: p(o) -
// n(o) / (1 + N) over their C slots; invalid actions masked at depth 0; ties
// to the first slot; stop at an unexpanded child or at max_depth); expand
// (a decision parent runs the decision tower on concat(s, one_hot(a)): the
// min-max normalised afterstate, the chance prior and the afterstate value;
// a chance parent runs the chance tower on concat(afterstate, one_hot(o)):
// the normalised next state and the reward, then the prediction tower on
// that state: the policy prior and the value; values and rewards are the
// softmax expectation over the 2S+1 bins, then h^-1); install with a
// running mean (a depth-capped descent re-evaluates the existing child in
// place and keeps its children); back up from the raw network value, where
// a decision edge carries r = 0 and gamma = 1 and a chance edge its reward
// and the discount. Outputs: the root's decision visits [B, A], its value
// [B] and the decision q [B, A] (the afterstates' values).
//
// What bounds it on this card. An expansion is 8,896 multiply-adds under a
// decision parent and 13,568 under a chance parent at bench.py's smz_mlp
// widths (E = 32, C = 32, hidden 64, 2S+1 = 41, A = 2): 256 envs x 200
// simulations are under 1.4 GFLOP, about 0.02 ms at the f32 rate, and the
// launch reads and writes well under a megabyte. Neither rate is the limit.
// The limit is the chain of dependent steps in each environment: a walk down
// the tree (one selection per level, each waiting for the previous child
// index), one tower evaluation, a walk back up, and the next simulation
// needs the updated statistics. The chain grows with the tree's depth, which
// grows as the network converges (the JAX package's r5 finding).
//
// What the design does about it. One warp owns one environment and branches
// on the parent's node type uniformly across its lanes, so it runs only the
// towers the expansion needs (the TPU kernel runs all three and blends them,
// because its lanes move in lockstep). The three towers' weights (22,877
// floats, 91.5 KB at smz_mlp widths) are staged once per block in shared
// memory. A tree does not fit beside them (about 166 KB per environment at
// 200 simulations), so the node arrays (visits, values, parent, creating
// slot: 3.2 KB) stay in shared memory and the edge arrays (child index as
// int32, prior, visits, reward, value: [N, A']) and the embeddings [N, E]
// live in a device scratch that the warp alone touches, held in L1 and L2.
// An edge row is initialised when its node is created. Lanes split the slots
// of a selection (warp shuffles find the maximum, ties to the lower slot),
// the outputs of each dense layer and the softmaxes; the install and the
// backup run on lane 0. Warps per block are chosen so that a launch gives at
// least one block per SM where the batch allows (one warp per block at 256
// environments: 256 blocks, two resident per SM). Splitting an
// environment's towers over several warps, and tensor cores, are left for
// later.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "warp_mlp.cuh"

// Returned when the shapes do not fit the kernel (too many layers, weights
// that do not fit the flat buffer or shared memory).
#define MZ_ERR_SHAPE (-1)

namespace {

using namespace mz_warp;

constexpr int kErrShape = MZ_ERR_SHAPE;
constexpr int kMaxLayers = 8;
constexpr int kMaxWarps = 8;
constexpr float kNeg = -1e30f;

struct Args {
  int B, A, C, E, S41, support;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dec, n_ch, n_pred;
  int dec_width[kMaxLayers], ch_width[kMaxLayers], pred_width[kMaxLayers];
  int ch_offset, pred_offset;  // floats: start of the chance, prediction towers
  int n_weights;               // floats in the flat weight buffer
  int weights_stride;          // floats of shared memory for the weights
  int act_width;               // floats per activation buffer
  int warp_floats;             // floats of shared memory per warp
  long env_floats;             // floats of device scratch per environment
  int warps_per_block;
};

// Index of the best slot among [lo, lo + n) of a node's row: decision nodes
// by PUCT under the parent-and-siblings qtransform (decision edges have r = 0
// and gamma = 1, and a decision node's chance slots are never visited, so
// they leave the min and max over the row unchanged), chance nodes by
// p(o) - n(o) / (1 + N). Every lane returns it.
__device__ int select_slot(bool decision, int row, int A, int C,
                           const float* cpri, const float* cvis,
                           const float* crew, const float* cval, float nvisit,
                           float nvalue, int depth, const float* inval,
                           float pb_c_init, float pb_c_base, int lane) {
  float best = -INFINITY;
  int best_a = INT_MAX;
  if (decision) {
    float lo = INFINITY, hi = -INFINITY;
    for (int a = lane; a < A; a += 32) {
      const float q = crew[row + a] + cval[row + a];
      const float safe_q = cvis[row + a] > 0.f ? q : nvalue;
      lo = fminf(lo, safe_q);
      hi = fmaxf(hi, safe_q);
    }
    const float minv = fminf(nvalue, warp_min(lo));
    const float maxv = fmaxf(nvalue, warp_max(hi));
    const float span = fmaxf(maxv - minv, 1e-8f);
    const float pb_c =
        pb_c_init + logf((nvisit + pb_c_base + 1.f) / pb_c_base);
    const float prior_scale = sqrtf(nvisit) * pb_c;
    for (int a = lane; a < A; a += 32) {
      const float cv = cvis[row + a];
      const float q = crew[row + a] + cval[row + a];
      const float completed = cv > 0.f ? q : minv;
      float score =
          (completed - minv) / span + prior_scale * cpri[row + a] / (cv + 1.f);
      if (depth == 0 && inval[a] > 0.f) score = kNeg;
      if (score > best) {  // a rises along the lane's stride: first max
        best = score;
        best_a = a;
      }
    }
  } else {
    float total = 0.f;
    for (int o = lane; o < C; o += 32) total += cvis[row + A + o];
    total = warp_sum(total);
    for (int o = lane; o < C; o += 32) {
      const float score =
          cpri[row + A + o] - cvis[row + A + o] / (1.f + total);
      if (score > best) {
        best = score;
        best_a = A + o;
      }
    }
  }
  return warp_argmax(best, best_a);
}

// y[E] (pre-activations) min-max normalised in place, eps 1e-8.
__device__ void normalize(float* y, int E, int lane) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < E; j += 32) {
    lo = fminf(lo, y[j]);
    hi = fmaxf(hi, y[j]);
  }
  lo = warp_min(lo);
  const float span = fmaxf(warp_max(hi) - lo, 1e-8f);
  for (int j = lane; j < E; j += 32) y[j] = (y[j] - lo) / span;
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxWarps)
fused_smz_kernel(const float* __restrict__ root_emb,
                 const float* __restrict__ root_logits,
                 const float* __restrict__ root_value,
                 const float* __restrict__ invalid,
                 const float* __restrict__ weights, float* scratch,
                 float* __restrict__ out_visits,
                 float* __restrict__ out_value, float* __restrict__ out_q,
                 const Args g) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < g.n_weights; i += blockDim.x)
    smem[i] = weights[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * g.warps_per_block + warp;
  if (env >= g.B) return;

  const int A = g.A, C = g.C, AP = A + C, E = g.E, N = g.num_nodes;
  const int S41 = g.S41;

  // This warp's shared memory: node arrays, three activation buffers, the
  // root's invalid mask.
  float* nvis = smem + g.weights_stride + warp * g.warp_floats;
  float* nval = nvis + N;
  int* npar = reinterpret_cast<int*>(nval + N);
  int* nact = npar + N;
  float* bufs[3] = {reinterpret_cast<float*>(nact + N),
                    reinterpret_cast<float*>(nact + N) + g.act_width,
                    reinterpret_cast<float*>(nact + N) + 2 * g.act_width};
  float* inval = bufs[2] + g.act_width;

  // This environment's edge arrays and embeddings in the device scratch.
  float* base = scratch + static_cast<size_t>(env) * g.env_floats;
  const size_t NA = static_cast<size_t>(N) * AP;
  int* cidx = reinterpret_cast<int*>(base);
  float* cpri = base + NA;
  float* cvis = base + 2 * NA;
  float* crew = base + 3 * NA;
  float* cval = base + 4 * NA;
  float* emb = base + 5 * NA;

  // ---- forest init: the root is a decision node with one visit ----------
  const float rv = root_value[env];
  for (int i = lane; i < N; i += 32) {
    nvis[i] = i == 0 ? 1.f : 0.f;
    nval[i] = i == 0 ? rv : 0.f;
    npar[i] = -1;
    nact[i] = -1;
  }
  for (int a = lane; a < AP; a += 32) {
    cidx[a] = -1;
    cpri[a] = 0.f;
    cvis[a] = 0.f;
    crew[a] = 0.f;
    cval[a] = 0.f;
  }
  for (int j = lane; j < E; j += 32)
    emb[j] = root_emb[static_cast<size_t>(env) * E + j];
  for (int a = lane; a < A; a += 32)
    inval[a] = invalid ? invalid[static_cast<size_t>(env) * A + a] : 0.f;
  __syncwarp();
  softmax_into(root_logits + static_cast<size_t>(env) * A, cpri, A, lane);

  for (int sim = 0; sim < g.num_simulations; ++sim) {
    // ---- descent ----------------------------------------------------------
    int cur = 0, parent = -1, act = -1, depth = 0;
    while (true) {
      const bool decision = cur == 0 || nact[cur] >= A;
      const int slot_sel = select_slot(
          decision, cur * AP, A, C, cpri, cvis, crew, cval, nvis[cur],
          nval[cur], depth, inval, g.pb_c_init, g.pb_c_base, lane);
      const int child = cidx[cur * AP + slot_sel];
      parent = cur;
      act = slot_sel;
      cur = child;
      ++depth;
      if (child < 0 || depth >= g.max_depth) break;
    }
    const int edge = parent * AP + act;
    const int existing = cidx[edge];
    // Fresh node sim+1, unless the depth cap stopped on an existing child.
    const int slot = existing < 0 ? sim + 1 : existing;
    const int srow = slot * AP;

    // ---- expansion: only the towers this parent's type needs -----------
    const bool decision_parent = parent == 0 || nact[parent] >= A;
    const int hot = decision_parent ? act : act - A;
    const int in0 = E + (decision_parent ? A : C);
    for (int j = lane; j < in0; j += 32)
      bufs[0][j] = j < E ? emb[parent * E + j] : (j - E == hot ? 1.f : 0.f);
    __syncwarp();
    float value, reward = 0.f;
    int k = 1, hw;
    if (decision_parent) {
      const float* p = smem;
      const float* h = run_hidden(p, bufs[0], in0, g.dec_width, g.n_dec, bufs,
                                  &k, &hw, lane);
      float* y = bufs[k];
      dense(p, p + hw * E, h, y, hw, E, false, lane);  // afterstate
      p += hw * E + E;
      normalize(y, E, lane);
      for (int j = lane; j < E; j += 32) emb[slot * E + j] = y[j];
      dense(p, p + hw * C, h, y, hw, C, false, lane);  // chance prior
      p += hw * C + C;
      softmax_into(y, cpri + srow + A, C, lane);
      for (int a = lane; a < A; a += 32) cpri[srow + a] = 0.f;
      dense(p, p + hw * S41, h, y, hw, S41, false, lane);  // afterstate value
      value = decode_support(y, S41, g.support, lane);
    } else {
      const float* p = smem + g.ch_offset;
      const float* h = run_hidden(p, bufs[0], in0, g.ch_width, g.n_ch, bufs,
                                  &k, &hw, lane);
      float* ns = bufs[2];
      dense(p, p + hw * E, h, ns, hw, E, false, lane);  // next state
      p += hw * E + E;
      normalize(ns, E, lane);
      for (int j = lane; j < E; j += 32) emb[slot * E + j] = ns[j];
      dense(p, p + hw * S41, h, bufs[k], hw, S41, false, lane);  // reward
      reward = decode_support(bufs[k], S41, g.support, lane);
      p = smem + g.pred_offset;
      k = 0;
      const float* q = run_hidden(p, ns, E, g.pred_width, g.n_pred, bufs, &k,
                                  &hw, lane);
      dense(p, p + hw * A, q, bufs[k], hw, A, false, lane);  // policy
      p += hw * A + A;
      softmax_into(bufs[k], cpri + srow, A, lane);
      for (int o = lane; o < C; o += 32) cpri[srow + A + o] = 0.f;
      dense(p, p + hw * S41, q, bufs[k], hw, S41, false, lane);  // value
      value = decode_support(bufs[k], S41, g.support, lane);
    }
    if (existing < 0) {  // a new node's edges start empty
      for (int a = lane; a < AP; a += 32) {
        cidx[srow + a] = -1;
        cvis[srow + a] = 0.f;
        crew[srow + a] = 0.f;
        cval[srow + a] = 0.f;
      }
    }
    __syncwarp();

    // ---- install (running mean) and backup with each edge's discount ----
    if (lane == 0) {
      const float count = nvis[slot];
      nval[slot] = (nval[slot] * count + value) / (count + 1.f);
      nvis[slot] = count + 1.f;
      npar[slot] = parent;
      nact[slot] = act;
      crew[edge] = reward;
      cidx[edge] = slot;
      int idx = slot;
      float v = value;
      while (idx != 0) {
        const int par = npar[idx];
        const int a = nact[idx];
        const int e = par * AP + a;
        const float gamma = a < A ? 1.f : g.discount;
        const float vnew = crew[e] + gamma * v;
        const float cnt = nvis[par];
        nval[par] = (nval[par] * cnt + vnew) / (cnt + 1.f);
        nvis[par] = cnt + 1.f;
        cval[e] = nval[idx];
        cvis[e] += 1.f;
        v = vnew;
        idx = par;
      }
    }
    __syncwarp();
  }

  // Decision-edge q is the afterstate's value (r = 0, gamma = 1).
  for (int a = lane; a < A; a += 32) {
    out_visits[static_cast<size_t>(env) * A + a] = cvis[a];
    out_q[static_cast<size_t>(env) * A + a] = cval[a];
  }
  if (lane == 0) out_value[env] = nval[0];
}

// Floats of one tower: hidden layers from `in`, then heads of the given
// widths on the last hidden activation. Leaves the last width in *last.
long tower_floats(int in, const int* widths, int n, const int* heads,
                  int n_heads, int* last) {
  long floats = 0;
  for (int l = 0; l < n; ++l) {
    floats += static_cast<long>(in) * widths[l] + widths[l];
    in = widths[l];
  }
  for (int h = 0; h < n_heads; ++h)
    floats += static_cast<long>(in) * heads[h] + heads[h];
  *last = in;
  return floats;
}

long env_floats(int A, int C, int E, int num_simulations) {
  const long N = num_simulations + 1;
  return 5 * N * (A + C) + N * E;
}

}  // namespace

extern "C" {

// Floats of device scratch the search needs for B environments.
long mz_smz_scratch_floats(int B, int A, int C, int E, int num_simulations) {
  return static_cast<long>(B) * env_floats(A, C, E, num_simulations);
}

// Launch the Stochastic MuZero search on `stream`. Inputs are env-major and
// contiguous f32: root_emb [B, E], root_logits [B, A] (the decision logits,
// noised and masked), root_value [B], invalid [B, A] or NULL. weights is the
// flat buffer of the three towers, per linear W [in, out] then b [out]: the
// decision tower's hidden layers (the first on E + A inputs), afterstate
// head [H, E], chance head [H, C], value head [H, S41]; the chance tower's
// hidden layers (the first on E + C), next-state head [H, E], reward head
// [H, S41]; the prediction tower's hidden layers (the first on E), policy
// head [H, A], value head [H, S41]. scratch holds
// mz_smz_scratch_floats(B, A, C, E, num_simulations) floats. Outputs: visits
// [B, A], value [B], q [B, A]. Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_smz_search(const float* root_emb, const float* root_logits,
                        const float* root_value, const float* invalid,
                        const float* weights, int n_weights, float* scratch,
                        long scratch_floats, float* out_visits,
                        float* out_value, float* out_q, int B, int A, int C,
                        int E, int S41, int support, int num_simulations,
                        int max_depth, float discount, float pb_c_init,
                        float pb_c_base, int n_dec, const int* dec_width,
                        int n_ch, const int* ch_width, int n_pred,
                        const int* pred_width, int device, void* stream) {
  if (n_dec < 1 || n_dec > kMaxLayers || n_ch < 1 || n_ch > kMaxLayers ||
      n_pred < 1 || n_pred > kMaxLayers || B < 1 || A < 1 || C < 1 ||
      E < 1 || S41 < 1 || num_simulations < 1 ||
      scratch_floats < mz_smz_scratch_floats(B, A, C, E, num_simulations))
    return kErrShape;
  Args g;
  g.B = B;
  g.A = A;
  g.C = C;
  g.E = E;
  g.S41 = S41;
  g.support = support;
  g.num_simulations = num_simulations;
  g.max_depth = max_depth;
  g.num_nodes = num_simulations + 1;
  g.discount = discount;
  g.pb_c_init = pb_c_init;
  g.pb_c_base = pb_c_base;
  g.n_dec = n_dec;
  g.n_ch = n_ch;
  g.n_pred = n_pred;
  int act_width = E + (A > C ? A : C);
  const int widest_head = E > C ? (E > S41 ? E : S41) : (C > S41 ? C : S41);
  if (widest_head > act_width) act_width = widest_head;
  for (int l = 0; l < n_dec; ++l) {
    g.dec_width[l] = dec_width[l];
    if (dec_width[l] > act_width) act_width = dec_width[l];
  }
  for (int l = 0; l < n_ch; ++l) {
    g.ch_width[l] = ch_width[l];
    if (ch_width[l] > act_width) act_width = ch_width[l];
  }
  for (int l = 0; l < n_pred; ++l) {
    g.pred_width[l] = pred_width[l];
    if (pred_width[l] > act_width) act_width = pred_width[l];
  }
  int last;
  const int dec_heads[3] = {E, C, S41};
  const int ch_heads[2] = {E, S41};
  const int pred_heads[2] = {A, S41};
  const long dec = tower_floats(E + A, dec_width, n_dec, dec_heads, 3, &last);
  const long ch = tower_floats(E + C, ch_width, n_ch, ch_heads, 2, &last);
  const long pred = tower_floats(E, pred_width, n_pred, pred_heads, 2, &last);
  if (dec + ch + pred != n_weights) return kErrShape;
  g.ch_offset = static_cast<int>(dec);
  g.pred_offset = static_cast<int>(dec + ch);
  g.n_weights = n_weights;
  g.weights_stride = (n_weights + 3) / 4 * 4;
  g.act_width = (act_width + 3) / 4 * 4;
  g.warp_floats = 4 * g.num_nodes + 3 * g.act_width + (A + 3) / 4 * 4;
  g.env_floats = env_floats(A, C, E, num_simulations);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0, sms = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // At least one block per SM where the batch allows, then as many warps
  // as the shared memory holds.
  int per_block = B / (sms > 0 ? sms : 1);
  if (per_block < 1) per_block = 1;
  if (per_block > kMaxWarps) per_block = kMaxWarps;
  while (per_block > 0 &&
         (static_cast<long>(g.weights_stride) +
          static_cast<long>(per_block) * g.warp_floats) * 4 > max_smem)
    --per_block;
  if (per_block == 0) return kErrShape;
  g.warps_per_block = per_block;
  const size_t smem = (static_cast<size_t>(g.weights_stride) +
                       static_cast<size_t>(per_block) * g.warp_floats) *
                      sizeof(float);
  err = cudaFuncSetAttribute(fused_smz_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (B + per_block - 1) / per_block;
  fused_smz_kernel<<<grid, 32 * per_block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      root_emb, root_logits, root_value, invalid, weights, scratch,
      out_visits, out_value, out_q, g);
  return cudaGetLastError();
}

const char* mz_smz_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused Stochastic MuZero search kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
