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
// needs the updated statistics. The walks grow with the tree's depth, which
// grows as the network converges: on the smz_mlp nets trained by the
// port's own fit the descents average 22 levels, against 3 on fresh nets.
//
// What the design does about it. Each level of a walk is a chain of
// shared-memory accesses, not of L2 round trips, and each expansion runs
// on four warps:
// - The tree is compact and lies in shared memory beside the towers'
//   weights (staged once per block). An edge's visits, value and reward
//   are always its child node's (each backup pass counts the edge and the
//   child together, sets the edge's value from the child's, and the reward
//   is written at each install of the child), so they are kept per node, in
//   one float4 with a fourth figure the selection needs (see Tree). An edge
//   keeps its child index (int16) and prior over max(A, C) slots a row: a
//   decision node uses A of them and a chance node C. A node's type
//   follows its depth. At smz_mlp widths and 200 simulations that is 42 KB
//   an environment; the embeddings [N, E] (25.7 KB) lie beside it where the
//   block has room.
// - A block holds one to three environments (search/fused.py
//   `smz_search_plan` picks how many, and where the trees and embeddings
//   live; where a tree does not fit beside the weights it goes to a device
//   scratch, held in L2). Each environment has four warps and a named
//   barrier of its own.
// - Towers wider than a block's shared memory (the 2048 example's widths:
//   embedding 64, 601 bins, hidden (256, 256), 3.05 MB) take the tile
//   kernel below (fused_smz_wide_kernel), whose environments share every
//   tower read.
// - The first warp walks the tree: lanes split the slots of a node, every
//   load of a level is issued at once, and shuffle rounds (or redux.sync
//   on order-keyed integers, past 4 lanes) find the first maximum with the
//   child it leads to. It records the path, so the backup needs no parent
//   pointer: the lanes load the path's rewards at once, run the discounted
//   returns up the path as one chain of multiply-adds in the walk's order
//   and arithmetic (v = r + gamma v), then update each node of the path in
//   parallel (the running mean (value n + v) / (n + 1), as before).
// - An expansion runs only the towers its parent's type needs. All four
//   warps split each dense layer's outputs (one lane an output, every input
//   summed in order, with the one-hot input as one row of W added after the
//   state's); the heads of a tower run as one layer; then the normaliser,
//   the softmax and each decode run at once on warps of their own, each sum
//   in a whole warp's order.
// - It keeps the arithmetic and the order of the one-warp kernel it
//   replaced, so it gives that kernel's outputs bit for bit. A division
//   whose numerator may be zero returns the zero itself: the IEEE division
//   takes a slow path (a subroutine call) for it.
// - No atomics: two launches on the same inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "warp_mlp.cuh"
#include "wide_tile.cuh"

// Returned when the shapes do not fit the kernel (too many layers, a tree
// past int16 indices, weights that do not fit the flat buffer or shared
// memory, or a launch plan whose sizes disagree with the kernel's layout).
#define MZ_ERR_SHAPE (-1)

namespace {

using namespace mz_warp;

constexpr int kErrShape = MZ_ERR_SHAPE;
constexpr int kMaxLayers = 8;
constexpr int kEnvWarps = 4;  // warps of one environment
constexpr int kEnvThreads = 32 * kEnvWarps;
constexpr int kMaxEnvs = 3;  // environments of one block
constexpr int kMaxNodes = 32767;  // int16 node indices
constexpr float kNeg = -1e30f;

struct Args {
  int B, A, C, K, E, S41, support;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  int n_dec, n_ch, n_pred;
  int dec_width[kMaxLayers], ch_width[kMaxLayers], pred_width[kMaxLayers];
  int ch_offset, pred_offset;  // floats: start of the chance, prediction towers
  int n_weights;               // floats in the flat weight buffer
  int weights_stride;          // floats of shared memory for the weights
  int max_hidden;              // floats of a hidden activation buffer
  int work_floats;             // floats of an environment's work buffers
  long tree_bytes;             // bytes of one compact tree
  long emb_bytes;              // bytes of one environment's embeddings
  long env_smem_bytes;         // bytes of shared memory per environment
  long env_scratch_bytes;      // bytes of device scratch per environment
  int envs_per_block, smem_emb;
};

// One environment's compact tree (see the design above). A node's type
// follows its depth: the root and every node at an even depth is a decision
// node, every node at an odd depth a chance node (a decision slot creates a
// chance node and a chance slot a decision node). A node's statistics are
// one float4, read by one load: x its visits, y its value, z the reward of
// the edge into it, w at a decision node its PUCT prior scale at x visits
// (sqrt(n) pb_c(n), set wherever the visits change) and at a chance node
// its children's visits (whole numbers, exact), which its selection needs.
struct Tree {
  float4* node;    // [N]
  float* cpri;     // [N, K] prior of each slot
  int16_t* cidx;   // [N, K] child of each slot, -1 unexpanded
  int16_t* path;   // [P] the nodes of the last descent, root first

  __device__ void place(char* base, int N, int K) {
    node = reinterpret_cast<float4*>(base);
    cpri = reinterpret_cast<float*>(node + N);
    cidx = reinterpret_cast<int16_t*>(cpri + static_cast<size_t>(N) * K);
    path = cidx + static_cast<size_t>(N) * K;
  }
};

// The sizes of one environment, shared by the launch and the plan's check
// (search/fused.py `smz_env_bytes` repeats them).
__host__ __device__ inline long round16(long bytes) {
  return (bytes + 15) / 16 * 16;
}

long tree_bytes_of(int N, int K, int P) {
  return round16(4L * (4L * N + static_cast<long>(N) * K) +
                 2L * (static_cast<long>(N) * K + P));
}

__host__ __device__ inline int up4(int floats) { return (floats + 3) / 4 * 4; }

// X [E], H0 and H1 [max_hidden], Y [E + C + S41], Z [A + S41], the invalid
// mask [A], each from a 16-byte boundary, then the control words [8].
int work_floats_of(int A, int C, int E, int S41, int max_hidden) {
  return up4(E) + 2 * up4(max_hidden) + up4(E + C + S41) + up4(A + S41) +
         up4(A) + 8;
}

// a / b for b > 0 where a may be zero: the IEEE division takes a slow path
// (a subroutine call) for a zero numerator, whose quotient is a itself.
__device__ __forceinline__ float div0(float a, float b) {
  return a == 0.f ? a : a / b;
}

// Floats as integers that order as the floats do (no NaN; -0 counts as +0).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float redux_min(float v) {
  return from_key(__reduce_min_sync(kFull, order_key(v)));
}

__device__ __forceinline__ float redux_max(float v) {
  return from_key(__reduce_max_sync(kFull, order_key(v)));
}

// The PUCT prior scale of a node with n visits: sqrt(n) (pb_c_init +
// log((n + pb_c_base + 1) / pb_c_base)). Kept per node, set wherever its
// visits change, so that a descent does not wait for it.
__device__ __forceinline__ float puct_scale(float n, float pb_c_init,
                                            float pb_c_base) {
  const float pb_c = pb_c_init + logf((n + pb_c_base + 1.f) / pb_c_base);
  return sqrtf(n) * pb_c;
}

// The first maximum over the warp's (score, slot, child) triples: the
// larger score, ties to the lower slot; a lane with no slot passes slot
// INT_MAX. Every lane gets the slot and its child.
__device__ __forceinline__ int first_max(float best, int best_a, int child,
                                         int* child_out) {
  const unsigned key = best_a == INT_MAX ? 0u : order_key(best);
  const unsigned top = __reduce_max_sync(kFull, key);
  const unsigned won = __reduce_min_sync(
      kFull, key == top && best_a != INT_MAX
                 ? (static_cast<unsigned>(best_a) << 16) |
                       (static_cast<unsigned>(child) & 0xffffu)
                 : 0xffffffffu);
  *child_out = static_cast<int16_t>(won & 0xffffu);
  return static_cast<int>(won >> 16);
}

// A row's n slots split over the lanes: lane l takes slots first = l mod
// span, first + span, ..., span the least power of two >= n (at most 32),
// so every group of span lanes sees every slot once and reduces to the
// whole result. Up to 4 lanes the reductions are shuffle rounds inside the
// group, past that redux.sync over the warp.
struct Split {
  int span, first;
  __device__ Split(int n, int lane) {
    span = 1;
    while (span < n && span < 32) span <<= 1;
    first = lane & (span - 1);
  }
  __device__ __forceinline__ float min(float v) const {
    if (span > 4) return redux_min(v);
    for (int o = span / 2; o > 0; o >>= 1)
      v = fminf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  __device__ __forceinline__ float max(float v) const {
    if (span > 4) return redux_max(v);
    for (int o = span / 2; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  // The first maximum of (best, slot), with the slot's child.
  __device__ __forceinline__ int argmax(float best, int slot, int child,
                                        int* child_out) const {
    if (span > 4) return first_max(best, slot, child, child_out);
    for (int o = span / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int os = __shfl_xor_sync(kFull, slot, o);
      const int oc = __shfl_xor_sync(kFull, child, o);
      if (ob > best || (ob == best && os < slot)) {
        best = ob;
        slot = os;
        child = oc;
      }
    }
    *child_out = child;
    return slot;
  }
};

// PUCT over a decision node's A slots under the parent-and-siblings
// qtransform (decision edges carry r = 0 and gamma = 1); invalid actions
// masked at depth 0. One warp; every lane returns the slot and its child.
// With A <= 32 a lane holds one slot at most, and its loads do not wait on
// one another.
__device__ int select_decision(const Tree& t, int cur, int K, int A,
                               const Split& sp, int depth,
                               const float* inval, int* child_out) {
  const float4 me = t.node[cur];  // y: value, w: the PUCT prior scale
  const int16_t* kids = t.cidx + static_cast<size_t>(cur) * K;
  const float* pri = t.cpri + static_cast<size_t>(cur) * K;
  if (A <= 32) {
    const int a = sp.first;
    const bool has = a < A;
    const int c = has ? kids[a] : -1;
    const float p = has ? pri[a] : 0.f;
    const float4 ch = t.node[c >= 0 ? c : 0];
    const float q = ch.z + ch.y;
    const float safe_q = c >= 0 ? q : me.y;
    const float minv = fminf(me.y, sp.min(has ? safe_q : INFINITY));
    const float maxv = fmaxf(me.y, sp.max(has ? safe_q : -INFINITY));
    const float span = fmaxf(maxv - minv, 1e-8f);
    const float completed = c >= 0 ? q : minv;
    const float cv = c >= 0 ? ch.x : 0.f;
    float score = div0(completed - minv, span) + div0(me.w * p, cv + 1.f);
    if (depth == 0 && has && inval[a] > 0.f) score = kNeg;
    return sp.argmax(has ? score : -INFINITY, has ? a : INT_MAX, c,
                     child_out);
  }
  float lo = INFINITY, hi = -INFINITY;
  for (int a = sp.first; a < A; a += 32) {
    const int c = kids[a];
    const float4 ch = t.node[c >= 0 ? c : 0];
    const float safe_q = c >= 0 ? ch.z + ch.y : me.y;
    lo = fminf(lo, safe_q);
    hi = fmaxf(hi, safe_q);
  }
  const float minv = fminf(me.y, redux_min(lo));
  const float maxv = fmaxf(me.y, redux_max(hi));
  const float span = fmaxf(maxv - minv, 1e-8f);
  float best = -INFINITY;
  int best_a = INT_MAX, best_c = -1;
  for (int a = sp.first; a < A; a += 32) {
    const int c = kids[a];
    const float4 ch = t.node[c >= 0 ? c : 0];
    const float cv = c >= 0 ? ch.x : 0.f;
    const float completed = c >= 0 ? ch.z + ch.y : minv;
    float score =
        div0(completed - minv, span) + div0(me.w * pri[a], cv + 1.f);
    if (depth == 0 && inval[a] > 0.f) score = kNeg;
    if (score > best) {  // a rises along the lane's stride: first max
      best = score;
      best_a = a;
      best_c = c;
    }
  }
  return first_max(best, best_a, best_c, child_out);
}

// p(o) - n(o) / (1 + N) over a chance node's C slots, N its children's
// visits (the node's w). One warp; every lane returns the slot (o, not
// A + o) and its child.
__device__ int select_chance(const Tree& t, int cur, int K, int C,
                             const Split& sp, int* child_out) {
  const float total = t.node[cur].w;
  const int16_t* kids = t.cidx + static_cast<size_t>(cur) * K;
  const float* pri = t.cpri + static_cast<size_t>(cur) * K;
  if (C <= 32) {
    const int o = sp.first;
    const bool has = o < C;
    const int c = has ? kids[o] : -1;
    const float p = has ? pri[o] : 0.f;
    const float cv = c >= 0 ? t.node[c >= 0 ? c : 0].x : 0.f;
    const float score = p - div0(cv, 1.f + total);
    return sp.argmax(has ? score : -INFINITY, has ? o : INT_MAX, c,
                     child_out);
  }
  float best = -INFINITY;
  int best_a = INT_MAX, best_c = -1;
  for (int o = sp.first; o < C; o += 32) {
    const int c = kids[o];
    const float cv = c >= 0 ? t.node[c >= 0 ? c : 0].x : 0.f;
    const float score = pri[o] - div0(cv, 1.f + total);
    if (score > best) {
      best = score;
      best_a = o;
      best_c = c;
    }
  }
  return first_max(best, best_a, best_c, child_out);
}

// ---- one simulation's walk in the wide kernel ------------------------------
//
// The same lines as the staged kernel's descent and its install and backup,
// which keeps its own copy: through these functions, ptxas gives its
// <true> instance 122 registers a thread against 119.

// Where a descent stopped: the leaf's parent, the action into the leaf (a,
// or A + o for an outcome o), the child already there (-1 if none) and the
// depth.
struct Leaf {
  int parent, act, child, depth;
};

// One simulation's descent on one warp: from the root, each decision node
// by PUCT and each chance node by its visit rule, to an unexpanded child or
// to g.max_depth; lane 0 records the path's nodes below the root. G: the
// kernel's arguments (Args or WideArgs), read where they are used.
template <typename G>
__device__ __forceinline__ Leaf descend(const Tree& t, int A, int C, int K,
                                        const G& g, const float* inval,
                                        int lane) {
  const Split split_a(A, lane), split_c(C, lane);
  int depth = 0, cur = 0, parent = 0, act = 0, child;
  while (true) {
    const bool decision = (depth & 1) == 0;
    const int s =
        decision ? select_decision(t, cur, K, A, split_a, depth, inval,
                                   &child)
                 : select_chance(t, cur, K, C, split_c, &child);
    parent = cur;
    act = decision ? s : A + s;
    cur = child;
    ++depth;
    if (child < 0 || depth >= g.max_depth) break;
    if (lane == 0) t.path[depth] = static_cast<int16_t>(child);
  }
  return Leaf{parent, act, child, depth};
}

// One warp: the install of `value` at `slot` (the leaf at depth d_leaf
// under `parent` by `act`; a running mean, *reward on the edge into it),
// then the backup from the raw value along the recorded path with each
// edge's discount. G as descend's.
template <typename G>
__device__ __forceinline__ void install_backup(
    const Tree& t, int slot, int parent, int act, int d_leaf, float value,
    const float* reward, int A, int K, const G& g, int lane) {
  if (lane == 0) {
    float4 n = t.node[slot];
    const float count = n.x;
    n.y = div0(n.y * count + value, count + 1.f);
    n.x = count + 1.f;
    n.z = *reward;
    // A decision node's prior scale follows its visits; a chance
    // node's children (w) are not touched by its own install.
    if ((d_leaf & 1) == 0)
      n.w = puct_scale(count + 1.f, g.pb_c_init, g.pb_c_base);
    t.node[slot] = n;
    t.cidx[static_cast<size_t>(parent) * K + (act < A ? act : act - A)] =
        static_cast<int16_t>(slot);
    t.path[d_leaf] = static_cast<int16_t>(slot);
  }
  __syncwarp();
  // Levels top, top - 1, ... of the path, 32 at a time: lane l loads
  // the reward into the node at level top - l, every lane runs the
  // chain of returns (the same instructions, so the same bits) with the
  // rewards shuffled in, lane l keeps the return into the parent of
  // level top - l, then each lane updates its parent's running mean; a
  // path holds each node once.
  float v = value;
  for (int top = d_leaf; top >= 1; top -= 32) {
    const int low = top > 32 ? top - 32 : 0;
    const int d = top - lane;
    const float r = d > low ? t.node[t.path[d]].z : 0.f;
    float into = 0.f;
#pragma unroll 8
    for (int k = 0; k < top - low; ++k) {
      // A node at an odd depth is a chance node: a decision edge (r = 0,
      // gamma = 1) leads to it.
      const float gamma = ((top - k) & 1) ? 1.f : g.discount;
      const float vnew = __shfl_sync(kFull, r, k) + gamma * v;
      if (lane == k) into = vnew;
      v = vnew;
    }
    if (d > low) {
      const int par = t.path[d - 1];
      float4 n = t.node[par];
      const float cnt = n.x;
      n.y = div0(n.y * cnt + into, cnt + 1.f);
      n.x = cnt + 1.f;
      // At depth d - 1: a decision node's prior scale, or one more
      // visit among a chance node's children.
      n.w = ((d - 1) & 1) == 0
                ? puct_scale(cnt + 1.f, g.pb_c_init, g.pb_c_base)
                : n.w + 1.f;
      t.node[par] = n;
    }
    __syncwarp();
  }
}

// ---- one environment's four warps ---------------------------------------

__device__ __forceinline__ void env_sync(int barrier) {
  asm volatile("bar.sync %0, %1;" ::"r"(barrier), "r"(kEnvThreads)
               : "memory");
}

// y[out] = x[in] @ W[rows, out] + b (+ extra, one row of W for a one-hot
// input after x), ELU if `elu_out`: the environment's lanes split the
// outputs, each sums its inputs in order.
__device__ __forceinline__ void env_dense(const float* W, const float* b,
                                          const float* x, float* y, int in,
                                          int out, const float* extra,
                                          bool elu_out, int tid) {
  const int in4 = in & ~3;  // x from a 16-byte boundary: four at a load
  for (int j = tid; j < out; j += kEnvThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < in4; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + i);
      acc = fmaf(xv.x, W[i * out + j], acc);
      acc = fmaf(xv.y, W[(i + 1) * out + j], acc);
      acc = fmaf(xv.z, W[(i + 2) * out + j], acc);
      acc = fmaf(xv.w, W[(i + 3) * out + j], acc);
    }
    for (int i = in4; i < in; ++i)
      acc = fmaf(x[i], W[i * out + j], acc);
    if (extra != nullptr) acc += extra[j];
    acc += b[j];
    y[j] = elu_out ? elu(acc) : acc;
  }
}

// Up to three heads on h[in], laid out one after the other in the flat
// weights from p (W [in, w] then b [w] each), as one layer: y holds their
// outputs side by side.
__device__ __forceinline__ void env_heads(const float* p, const float* h,
                                          int in, int w0, int w1, int w2,
                                          float* y, int tid) {
  const int total = w0 + w1 + w2;
  const int in4 = in & ~3;  // h from a 16-byte boundary: four at a load
  for (int o = tid; o < total; o += kEnvThreads) {
    const float* W = p;
    int j = o, out = w0;
    if (j >= w0) {
      W += in * w0 + w0;
      j -= w0;
      out = w1;
      if (j >= w1) {
        W += in * w1 + w1;
        j -= w1;
        out = w2;
      }
    }
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < in4; i += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h + i);
      acc = fmaf(hv.x, W[i * out + j], acc);
      acc = fmaf(hv.y, W[(i + 1) * out + j], acc);
      acc = fmaf(hv.z, W[(i + 2) * out + j], acc);
      acc = fmaf(hv.w, W[(i + 3) * out + j], acc);
    }
    for (int i = in4; i < in; ++i)
      acc = fmaf(h[i], W[i * out + j], acc);
    y[o] = acc + W[in * out + j];
  }
}

// The hidden ELU layers of one tower from x (width `in`, the first layer's
// one-hot row `hot` of W when hot >= 0), through bufs[0], bufs[1], ...;
// `p` walks the flat weights. Returns the last hidden activation and leaves
// its width in *width. Ends with the environment's barrier.
__device__ const float* env_hidden(const float*& p, const float* x, int in,
                                   int hot_rows, int hot, const int* widths,
                                   int n, float* bufs0, float* bufs1,
                                   int* width, int tid, int barrier) {
  for (int l = 0; l < n; ++l) {
    const int out = widths[l];
    const int rows = l == 0 ? in + hot_rows : in;
    float* y = (l & 1) ? bufs1 : bufs0;
    env_dense(p, p + rows * out, x, y, in, out,
              l == 0 && hot >= 0 ? p + (in + hot) * out : nullptr, true, tid);
    p += rows * out + out;
    x = y;
    in = out;
    env_sync(barrier);
  }
  *width = in;
  return x;
}

// One warp: softmax over the n support logits (overwritten), expectation
// over the bins -S..S, then h^-1 (warp_mlp.cuh's decode_support, its max
// taken by redux.sync). Every lane returns the value.
__device__ float warp_decode(float* logits, int n, int support, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, logits[j]);
  m = redux_max(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(logits[j] - m);
    logits[j] = e;
    s += e;
  }
  s = warp_sum(s);
  float x = 0.f;
  for (int j = lane; j < n; j += 32)
    x += div0(logits[j], s) * static_cast<float>(j - support);
  x = warp_sum(x);
  return inv_value_transform(x);
}

// One warp: softmax over n logits into out.
__device__ void warp_softmax(const float* logits, float* out, int n,
                             int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, logits[j]);
  m = redux_max(m);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) s += expf(logits[j] - m);
  s = warp_sum(s);
  for (int j = lane; j < n; j += 32) out[j] = div0(expf(logits[j] - m), s);
}

// One warp: y[E] (pre-activations) min-max normalised (eps 1e-8) into y and
// into the embedding row `to`.
__device__ void warp_normalize(float* y, float* to, int E, int lane) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < E; j += 32) {
    lo = fminf(lo, y[j]);
    hi = fmaxf(hi, y[j]);
  }
  lo = redux_min(lo);
  const float span = fmaxf(redux_max(hi) - lo, 1e-8f);
  for (int j = lane; j < E; j += 32) {
    const float v = div0(y[j] - lo, span);
    y[j] = v;
    to[j] = v;
  }
}

// The control words an environment's warps exchange through shared memory.
enum Ctl { kParent, kAct, kSlot, kExisting, kDepth, kDecisionParent,
           kValue, kReward };

// The towers are staged once per block in shared memory; towers wider than
// that take fused_smz_wide_kernel below.
template <bool kSmemTree>
__global__ void __launch_bounds__(kEnvThreads * kMaxEnvs, 1)
fused_smz_kernel(const float* __restrict__ root_emb,
                 const float* __restrict__ root_logits,
                 const float* __restrict__ root_value,
                 const float* __restrict__ invalid,
                 const float* __restrict__ weights, char* scratch,
                 float* __restrict__ out_visits,
                 float* __restrict__ out_value, float* __restrict__ out_q,
                 const __grid_constant__ Args g) {
  extern __shared__ __align__(16) float smem[];
  if ((reinterpret_cast<uintptr_t>(weights) & 15) == 0) {
    const int n4 = g.n_weights / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(smem)[i] =
          reinterpret_cast<const float4*>(weights)[i];
    for (int i = 4 * n4 + threadIdx.x; i < g.n_weights; i += blockDim.x)
      smem[i] = weights[i];
  } else {
    for (int i = threadIdx.x; i < g.n_weights; i += blockDim.x)
      smem[i] = weights[i];
  }
  __syncthreads();
  const float* towers = smem;

  const int local = threadIdx.x / kEnvThreads;
  const int env = blockIdx.x * g.envs_per_block + local;
  if (env >= g.B) return;
  const int tid = threadIdx.x % kEnvThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int barrier = 1 + local;  // 0 is __syncthreads'
  const int A = g.A, C = g.C, K = g.K, E = g.E, N = g.num_nodes;
  const int S41 = g.S41;
  const size_t e = static_cast<size_t>(env);

  // This environment's shared memory: the work buffers, then the
  // embeddings and the tree where the plan keeps them here; the rest in
  // its slice of the scratch.
  char* mine = reinterpret_cast<char*>(smem + g.weights_stride) +
               static_cast<size_t>(local) * g.env_smem_bytes;
  char* spill = scratch + e * g.env_scratch_bytes;
  float* X = reinterpret_cast<float*>(mine);
  float* H0 = X + up4(E);
  float* H1 = H0 + up4(g.max_hidden);
  float* Y = H1 + up4(g.max_hidden);
  float* Z = Y + up4(E + C + S41);
  float* inval = Z + up4(A + S41);
  int* ctl = reinterpret_cast<int*>(inval + up4(A));
  float* ctlf = reinterpret_cast<float*>(ctl);
  char* after = mine + 4L * g.work_floats;
  float* emb;
  if (g.smem_emb) {
    emb = reinterpret_cast<float*>(after);
    after += g.emb_bytes;
  } else {
    emb = reinterpret_cast<float*>(spill + (kSmemTree ? 0 : g.tree_bytes));
  }
  Tree t;
  t.place(kSmemTree ? after : spill, N, K);

  // ---- forest init: the root is a decision node with one visit ----------
  const float rv = root_value[env];
  for (int i = tid; i < N; i += kEnvThreads)
    t.node[i] = i == 0 ? make_float4(1.f, rv, 0.f,
                                     puct_scale(1.f, g.pb_c_init,
                                                g.pb_c_base))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = tid; s < K; s += kEnvThreads) t.cidx[s] = -1;
  for (int j = tid; j < E; j += kEnvThreads) emb[j] = root_emb[e * E + j];
  for (int a = tid; a < A; a += kEnvThreads)
    inval[a] = invalid ? invalid[e * A + a] : 0.f;
  if (warp == 0) warp_softmax(root_logits + e * A, t.cpri, A, lane);
  if (tid == 0) t.path[0] = 0;
  env_sync(barrier);

  for (int sim = 0; sim < g.num_simulations; ++sim) {
    int depth = 0;
    // ---- descent -------------------------------------------------------
    if (warp == 0) {
      const Split split_a(A, lane), split_c(C, lane);
      int cur = 0, parent = 0, act = 0, child;
      while (true) {
        const bool decision = (depth & 1) == 0;
        const int s =
            decision ? select_decision(t, cur, K, A, split_a, depth, inval,
                                       &child)
                     : select_chance(t, cur, K, C, split_c, &child);
        parent = cur;
        act = decision ? s : A + s;
        cur = child;
        ++depth;
        if (child < 0 || depth >= g.max_depth) break;
        if (lane == 0) t.path[depth] = static_cast<int16_t>(child);
      }
      if (lane == 0) {
        ctl[kParent] = parent;
        ctl[kAct] = act;
        ctl[kExisting] = child;
        // Fresh node sim+1, unless the depth cap stopped on an existing
        // child.
        ctl[kSlot] = child < 0 ? sim + 1 : child;
        ctl[kDepth] = depth;
        ctl[kDecisionParent] = ((depth - 1) & 1) == 0;
      }
    }
    env_sync(barrier);

    // ---- expansion: only the towers this parent's type needs -----------
    const int parent = ctl[kParent], act = ctl[kAct], slot = ctl[kSlot];
    const bool fresh = ctl[kExisting] < 0;
    float* srow = t.cpri + static_cast<size_t>(slot) * K;
    for (int j = tid; j < E; j += kEnvThreads)
      X[j] = emb[static_cast<size_t>(parent) * E + j];
    if (fresh) {  // a new node's edges start unexpanded
      int16_t* kids = t.cidx + static_cast<size_t>(slot) * K;
      for (int s = tid; s < K; s += kEnvThreads) kids[s] = -1;
    }
    env_sync(barrier);
    float* to = emb + static_cast<size_t>(slot) * E;
    int hw;
    if (ctl[kDecisionParent]) {
      const float* p = towers;
      const float* h = env_hidden(p, X, E, A, act, g.dec_width, g.n_dec, H0,
                                  H1, &hw, tid, barrier);
      // afterstate [E], chance prior [C], afterstate value [S41]
      env_heads(p, h, hw, E, C, S41, Y, tid);
      env_sync(barrier);
      if (warp == 0) {
        warp_normalize(Y, to, E, lane);
      } else if (warp == 1) {
        warp_softmax(Y + E, srow, C, lane);
      } else if (warp == 2) {
        const float value = warp_decode(Y + E + C, S41, g.support, lane);
        if (lane == 0) {
          ctlf[kValue] = value;
          ctlf[kReward] = 0.f;
        }
      }
    } else {
      const float* p = towers + g.ch_offset;
      const float* h = env_hidden(p, X, E, C, act - A, g.ch_width, g.n_ch,
                                  H0, H1, &hw, tid, barrier);
      // next state [E], reward [S41]
      env_heads(p, h, hw, E, S41, 0, Y, tid);
      env_sync(barrier);
      if (warp == 0) {
        warp_normalize(Y, to, E, lane);
      } else if (warp == 1) {
        const float reward = warp_decode(Y + E, S41, g.support, lane);
        if (lane == 0) ctlf[kReward] = reward;
      }
      env_sync(barrier);
      p = towers + g.pred_offset;
      h = env_hidden(p, Y, E, 0, -1, g.pred_width, g.n_pred, H0, H1, &hw, tid,
                     barrier);
      // policy [A], value [S41]
      env_heads(p, h, hw, A, S41, 0, Z, tid);
      env_sync(barrier);
      if (warp == 0) {
        warp_softmax(Z, srow, A, lane);
      } else if (warp == 1) {
        const float value = warp_decode(Z + A, S41, g.support, lane);
        if (lane == 0) ctlf[kValue] = value;
      }
    }
    env_sync(barrier);

    // ---- install (running mean) and backup with each edge's discount ----
    if (warp == 0) {
      const int d_leaf = ctl[kDepth];
      const float value = ctlf[kValue];
      if (lane == 0) {
        float4 n = t.node[slot];
        const float count = n.x;
        n.y = div0(n.y * count + value, count + 1.f);
        n.x = count + 1.f;
        n.z = ctlf[kReward];
        // A decision node's prior scale follows its visits; a chance
        // node's children (w) are not touched by its own install.
        if ((d_leaf & 1) == 0)
          n.w = puct_scale(count + 1.f, g.pb_c_init, g.pb_c_base);
        t.node[slot] = n;
        t.cidx[static_cast<size_t>(parent) * K + (act < A ? act : act - A)] =
            static_cast<int16_t>(slot);
        t.path[d_leaf] = static_cast<int16_t>(slot);
      }
      __syncwarp();
      // Levels top, top - 1, ... of the path, 32 at a time: lane l loads
      // the reward into the node at level top - l, every lane runs the
      // chain of returns (the same instructions, so the same bits) with the
      // rewards shuffled in, lane l keeps the return into the parent of
      // level top - l, then each lane updates its parent's running mean; a
      // path holds each node once.
      float v = value;
      for (int top = d_leaf; top >= 1; top -= 32) {
        const int low = top > 32 ? top - 32 : 0;
        const int d = top - lane;
        const float r = d > low ? t.node[t.path[d]].z : 0.f;
        float into = 0.f;
#pragma unroll 8
        for (int k = 0; k < top - low; ++k) {
          // A node at an odd depth is a chance node: a decision edge (r = 0,
          // gamma = 1) leads to it.
          const float gamma = ((top - k) & 1) ? 1.f : g.discount;
          const float vnew = __shfl_sync(kFull, r, k) + gamma * v;
          if (lane == k) into = vnew;
          v = vnew;
        }
        if (d > low) {
          const int par = t.path[d - 1];
          float4 n = t.node[par];
          const float cnt = n.x;
          n.y = div0(n.y * cnt + into, cnt + 1.f);
          n.x = cnt + 1.f;
          // At depth d - 1: a decision node's prior scale, or one more
          // visit among a chance node's children.
          n.w = ((d - 1) & 1) == 0
                    ? puct_scale(cnt + 1.f, g.pb_c_init, g.pb_c_base)
                    : n.w + 1.f;
          t.node[par] = n;
        }
        __syncwarp();
      }
    }
  }

  // Decision-edge q is the afterstate's value (r = 0, gamma = 1).
  if (warp == 0) {
    for (int a = lane; a < A; a += 32) {
      const int c = t.cidx[a];
      out_visits[e * A + a] = c >= 0 ? t.node[c].x : 0.f;
      out_q[e * A + a] = c >= 0 ? t.node[c].y : 0.f;
    }
    if (lane == 0) out_value[env] = t.node[0].y;
  }
}

// Floats of one tower: hidden layers from `in`, then heads of the given
// widths on the last hidden activation.
long tower_floats(int in, const int* widths, int n, const int* heads,
                  int n_heads) {
  long floats = 0;
  for (int l = 0; l < n; ++l) {
    floats += static_cast<long>(in) * widths[l] + widths[l];
    in = widths[l];
  }
  for (int h = 0; h < n_heads; ++h)
    floats += static_cast<long>(in) * heads[h] + heads[h];
  return floats;
}

using SMZKernel = decltype(&fused_smz_kernel<true>);

// The instance of a plan: the trees in shared memory or not.
SMZKernel smz_instance(int smem_tree) {
  return smem_tree ? fused_smz_kernel<true> : fused_smz_kernel<false>;
}

// ---- towers wider than a block's shared memory: tiles of environments ----
//
// Towers past a block's shared memory (examples/run_2048.py's widths: A =
// 4, C = 32, E = 64, hidden (256, 256), 601 bins; 762,031 floats, 3.05 MB)
// take fused_smz_wide_kernel. As in fused_search.cu's wide kernel, a tile
// of kT environments (16 or 48) shares every read of the towers: each
// simulation walks every tree of the tile (a warp an environment), then
// expands the tile's leaves at once, part by part, each part one [kT, in]
// x [in, cols] product on the tensor cores (3xTF32,
// wide_tile.cuh) ended by a cluster barrier. A tile belongs to a cluster
// of kC blocks (16 or 4); each block computes a kC-th of every product's
// columns for all kT rows and writes them where they are read (distributed
// shared memory, four columns a 16-byte store, the warps of a split of
// the k-steps each storing to their share of the blocks): a hidden layer
// and the chance tower's next state into every block of the cluster, a
// head's logits into the block that walks the environment, which
// normalises, runs the softmax and decodes with whole rows.
//
// Every row goes through all three towers, and each head's output is kept
// where the row's parent type wants it (the TPU kernel's both-branches
// idiom): a decision parent keeps the decision tower's afterstate, chance
// prior and value; a chance parent the chance tower's next state and
// reward, then the prediction tower's policy and value on that state. That
// is 758 K multiply-adds a row against about 450 K of the towers a row
// needs (80 % chance parents at 200 simulations), for one chain of parts
// where rows sorted by parent type would need two kinds of tiles. The
// one-hot input (the action, or the outcome) stays one row of W added to a
// row's sums after the state's, as in the staged kernel.
//
// The weights reach a block cut to its columns: the wrapper packs the flat
// towers into one run per cluster rank (search/fused.py
// `pack_smz_wide_towers`): the biases and one-hot rows of every part, then
// each part's [in8, nb] slice in the parts' order. The plan keeps a prefix
// of the parts resident (staged once by TMA bulk copies with the biases)
// and streams the rest through a ring of slots (one copy for all the
// block's warps, issued ahead across parts and simulations by thread 0
// once every warp released a slot), in pieces of as many rows as fill a
// slot; a warp's k-steps do not depend on where the pieces end, so every
// layout gives the same bits. The compact trees and the embeddings lie in
// the device scratch (held in L2), which leaves the block's shared memory
// to the towers.
//
// What bounds it: per row and simulation 758 K multiply-adds, so 1024
// boards x 200 simulations are 310 GFLOP: 4.6 ms at the f32 FMA peak, 1.9
// ms at the TF32 tensor-core peak taken three times; and 3.05 MB of towers
// a tile and simulation from L2. Its real limit is the chain of dependent
// parts, each ended by a cluster barrier, the walks and the decodes
// between them.

constexpr int kWideWarps = mz_wide::kWarps;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kMaxParts = 3 * (kMaxLayers + 1);
constexpr int kPieceRows = 32;      // rows of the widest streamed part's piece
constexpr int kMaxRing = 8;
constexpr int kBarrierFloats = 64;  // the mbarriers, at the start
constexpr int kCopyFloats = 8192;   // floats of one staging bulk copy

// What a part's sums become: a hidden layer's ELU in every block; the
// decision tower's heads (afterstate, chance logits, value logits), the
// chance tower's (next state into every block, reward logits) or the
// prediction tower's (policy, value logits), each head's logits into the
// owning block's row where the row's parent type keeps them.
enum WideKind { kHidden, kDecHeads, kChHeads, kPredHeads };
// A part's input: X (the parents' embeddings, later the next states) or a
// hidden buffer, which is also a hidden part's output.
enum WideBuf { kBufX, kBufH0, kBufH1 };
// The one-hot row a part adds: none, the action (decision parents), the
// outcome (chance parents).
enum WideHot { kHotNone, kHotAction, kHotOutcome };

struct WideArgs {
  int B, A, C, K, E, S41, support;
  int num_simulations, max_depth, num_nodes;
  float discount, pb_c_init, pb_c_base;
  // Parts in the order they run; after part `mid` the decision and chance
  // heads are whole.
  int n_parts, mid;
  // Part p: its input width (in8 rows in the pack, a multiple of 8), its
  // output width, the columns nb of every block (block r computes [r nb,
  // r nb + nb)); its input buffer, what its sums become, the hidden buffer
  // of a hidden part, its one-hot row; its weights', biases' and one-hot
  // rows' offsets in a rank's pack; the rows of its pieces and its first
  // streamed piece in a simulation.
  int in[kMaxParts], in8[kMaxParts], width[kMaxParts], nb[kMaxParts];
  int src[kMaxParts], kind[kMaxParts], dst[kMaxParts], hot[kMaxParts];
  int w_off[kMaxParts], b_off[kMaxParts], h_off[kMaxParts];
  int prow[kMaxParts], spiece0[kMaxParts + 1];
  int n_resident;   // parts [0, n_resident) stay in shared memory
  int n_stream;     // streamed pieces a simulation
  int res_floats;   // floats of a rank's pack staged at the start
  int rank_floats;  // floats of a rank's pack
  int ring, slot_floats;
  // Floats per row of X, of the hidden buffers and of an environment's
  // logits: each 4 more than a multiple of 32.
  int ld_x, ld, ld_l;
  long tree_bytes;  // bytes of one compact tree
  long tree_base;   // scratch bytes before the trees: the B N E embeddings
  // Shared memory (floats from its start): the barriers, the staged pack,
  // the ring, X, the two hidden buffers, the block's logits, the warps'
  // partial sums, the invalid masks, the per-env control words, the
  // tile's one-hot indices.
  int s_ring, s_x, s_h0, s_h1, s_l, s_red, s_inval, s_ctl, s_hot,
      smem_floats;
};

// An environment's control words in the wide kernel.
enum WideCtl { kWParent, kWAct, kWSlot, kWDepth, kWValue, kWReward };
constexpr int kCtlWords = 8;

// The pieces of a launch: the streamed piece q = sim n_stream + i is the
// i-th of a simulation's sequence, part after part.
struct WidePieces {
  const float* pack;  // this rank's pack in device memory
  const float* spack;  // its staged prefix in shared memory
  mz_wide::Ring ring;
  long total;  // streamed pieces in the launch

  // Thread 0: the copy of streamed piece q into its slot.
  __device__ void issue(const WideArgs& wa, long q) const {
    const int local = static_cast<int>(q % wa.n_stream);
    int p = wa.n_resident;
    while (local >= wa.spiece0[p + 1]) ++p;
    const int i = local - wa.spiece0[p];
    const int rows = min(wa.prow[p], wa.in8[p] - wa.prow[p] * i);
    ring.issue(q, pack + wa.w_off[p] + static_cast<long>(wa.prow[p]) * i *
                             wa.nb[p],
               4u * rows * wa.nb[p]);
  }
};

// One part: acc = X [kT, in] W[:, this block's columns] over its pieces,
// the one-hot row and the bias added to each sum in that order, and the
// sums stored as its kind says. q0: the part's first streamed piece.
template <int kT, int kC, int kNTW>
__device__ void wide_part(const WideArgs& wa, const WidePieces& st, int p,
                          long q0, float* X, float* const* H, float* L,
                          float* red, const int* hot, int rank) {
  namespace cg = cooperative_groups;
  constexpr int kRankEnvs = kT / kC;
  const int nbs = wa.nb[p], prow = wa.prow[p], in8 = wa.in8[p];
  const bool res = p < wa.n_resident;
  const float* x = wa.src[p] == kBufX ? X : H[wa.src[p] - kBufH0];
  const int ldx = wa.src[p] == kBufX ? wa.ld_x : wa.ld;
  float acc[kT / 16][kNTW][4];
  int ng, groups;
  mz_wide::tile_product<kT, kNTW>(
      x, ldx, wa.in[p], nbs, (in8 + prow - 1) / prow, in8, prow,
      [&](int pi) {
        return res ? st.spack + wa.w_off[p] + prow * pi * nbs
                   : st.ring.wait(q0 + pi);
      },
      [&](int pi) {
        if (res) return;
        st.ring.arrive(q0 + pi);
        if (threadIdx.x == 0 && q0 + pi + wa.ring < st.total)
          st.issue(wa, q0 + pi + wa.ring);
        __syncwarp();
      },
      red, acc, &ng, &groups);

  cg::cluster_group cluster = cg::this_cluster();
  const float* bias = st.spack + wa.b_off[p];
  const float* hrow = st.spack + wa.h_off[p];
  const int c0 = rank * nbs, width = wa.width[p], kind = wa.kind[p];
  const int hk = wa.hot[p], A = wa.A, E = wa.E;
  const int nt = nbs / 8, S = mz_wide::k_split(nt);
  const int ks0 = (threadIdx.x >> 5) % S, lane = threadIdx.x & 31;
  float* out = kind == kHidden ? H[wa.dst[p] - kBufH0] : X;
  // The sum of column n of row m with its one-hot row and bias.
  auto finish = [&](float v, int m, int n) {
    const int h = hot[m];  // -1 past the batch, a < A, or A + o
    if (hk == kHotAction && h >= 0 && h < A) v += hrow[h * nbs + n];
    if (hk == kHotOutcome && h >= A) v += hrow[(h - A) * nbs + n];
    return v + bias[n];
  };
  // The first `valid` of four columns into dst[idx] of block `to` of the
  // cluster (where this warp of the split stores the owner's rows), or, to
  // < 0, of the blocks congruent to this warp mod S: one 16-byte store
  // where all four go to a multiple of 4.
  auto put = [&](float* dst, int idx, float4 q, int valid, int to) {
    if (valid <= 0 || (to >= 0 && to % S != ks0)) return;
    for (int r = to < 0 ? ks0 : to; r < (to < 0 ? kC : to + 1); r += S) {
      float* d = cluster.map_shared_rank(dst, r) + idx;
      if (valid == 4 && (idx & 3) == 0) {
        *reinterpret_cast<float4*>(d) = q;
      } else {
        const float e[4] = {q.x, q.y, q.z, q.w};
        for (int k = 0; k < valid; ++k) d[k] = e[k];
      }
    }
  };
  // Each warp of a split holds every sum of its column tiles: a lane's
  // columns n0, n0 + 1 of rows g and g + 8 (mma's C fragment). Lanes t and
  // t ^ 1 swap halves, so that an even lane holds four columns of row g and
  // an odd one four of row g + 8, one store each.
  const int g = lane >> 2, t = lane & 3;
  const bool even = (t & 1) == 0;
#pragma unroll
  for (int j = 0; j < kNTW; ++j) {
    const int tile = ng + groups * j;
    if (tile >= nt) break;
#pragma unroll
    for (int i = 0; i < kT / 16; ++i) {
      const int n0 = 8 * tile + 2 * t;
      float v[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int n = n0 + (h & 1);
        v[h] = c0 + n < width ? finish(acc[i][j][h], 16 * i + g + 8 * (h >> 1),
                                       n)
                              : 0.f;
        if (kind == kHidden) v[h] = elu(v[h]);
      }
      const float x0 = __shfl_xor_sync(kFull, even ? v[2] : v[0], 1);
      const float x1 = __shfl_xor_sync(kFull, even ? v[3] : v[1], 1);
      const float4 q = even ? make_float4(v[0], v[1], x0, x1)
                            : make_float4(x0, x1, v[2], v[3]);
      const int m = 16 * i + g + (even ? 0 : 8);
      const int col = c0 + (even ? n0 : n0 - 2);  // four columns from here
      const int valid = min(4, width - col);
      const int h = hot[m], owner = m / kRankEnvs, row = m % kRankEnvs;
      if (kind == kHidden) {
        put(out, m * wa.ld + col, q, valid, -1);
      } else if (kind == kChHeads && col < E) {
        // The next state into every block; reward logits past it.
        put(out, m * wa.ld_x + col, q, min(valid, E - col), -1);
        if (col + valid > E && h >= A) {
          const float e[4] = {q.x, q.y, q.z, q.w};
          for (int k = E - col; k < valid; ++k)
            put(L, row * wa.ld_l + col + k - E,
                make_float4(e[k], 0.f, 0.f, 0.f), 1, owner);
        }
      } else if (kind == kDecHeads ? (h >= 0 && h < A) : h >= A) {
        put(L, row * wa.ld_l + col - (kind == kChHeads ? E : 0), q, valid,
            owner);
      }
    }
  }
}

template <int kT, int kC, int kNTW>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_smz_wide_kernel(const float* __restrict__ root_emb,
                      const float* __restrict__ root_logits,
                      const float* __restrict__ root_value,
                      const float* __restrict__ invalid,
                      const float* __restrict__ pack, char* scratch,
                      float* __restrict__ out_visits,
                      float* __restrict__ out_value,
                      float* __restrict__ out_q,
                      const __grid_constant__ WideArgs wa) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float wide_smem[];
  constexpr int kRankEnvs = kT / kC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int A = wa.A, C = wa.C, K = wa.K, E = wa.E, N = wa.num_nodes;
  const int S41 = wa.S41;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = rank * kRankEnvs;  // this block's rows of the tile
  const int env0 = static_cast<int>(blockIdx.x) / kC * kT + row0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wide_smem);
  float* spack = wide_smem + kBarrierFloats;
  WidePieces st;
  st.pack = pack + static_cast<long>(rank) * wa.rank_floats;
  st.spack = spack;
  st.ring = {wide_smem + wa.s_ring, bars + 1, bars + 1 + kMaxRing, wa.ring,
             wa.slot_floats};
  st.total = static_cast<long>(wa.num_simulations) * wa.n_stream;
  float* X = wide_smem + wa.s_x;  // parents' embeddings, then next states
  float* H[2] = {wide_smem + wa.s_h0, wide_smem + wa.s_h1};
  float* L = wide_smem + wa.s_l;  // the block's logits [kRankEnvs, ld_l]
  float* red = wide_smem + wa.s_red;
  float* inval = wide_smem + wa.s_inval;  // [kRankEnvs, A]
  int* ctl = reinterpret_cast<int*>(wide_smem + wa.s_ctl);
  int* hot = reinterpret_cast<int*>(wide_smem + wa.s_hot);  // [kT]
  char* trees = scratch + wa.tree_base + env0 * wa.tree_bytes;
  float* embs = reinterpret_cast<float*>(scratch);  // [B, N, E]
  auto tree = [&](int i) {
    Tree t;
    t.place(trees + i * wa.tree_bytes, N, K);
    return t;
  };
  auto emb = [&](int i, int node) {
    return embs + (static_cast<long>(env0 + i) * N + node) * E;
  };

  // ---- staging: the biases, one-hot rows and resident parts, the first
  // streamed pieces; the buffers zeroed; each env's root
  if (threadIdx.x == 0) {
    mz_wide::mbar_init(bars, 1);
    for (int s = 0; s < wa.ring; ++s) {
      mz_wide::mbar_init(st.ring.full + s, 1);
      mz_wide::mbar_init(st.ring.empty + s, kWideWarps);
    }
    mz_wide::mbar_fence_init();
    mz_wide::mbar_expect_tx(bars, 4u * wa.res_floats);
    for (int off = 0; off < wa.res_floats; off += kCopyFloats)
      mz_wide::bulk_copy(spack + off, st.pack + off,
                         4u * min(kCopyFloats, wa.res_floats - off), bars);
    for (long q = 0; q < wa.ring && q < st.total; ++q) st.issue(wa, q);
  }
  for (int k = threadIdx.x; k < wa.s_l - wa.s_x; k += kWideThreads)
    X[k] = 0.f;  // X, H0 and H1: rows past the batch stay finite
  for (int m = threadIdx.x; m < kT; m += kWideThreads) hot[m] = -1;
  for (int i = warp; i < kRankEnvs; i += kWideWarps) {
    const int env = env0 + i;
    for (int a = lane; a < A; a += 32)
      inval[i * A + a] =
          (env < wa.B && invalid) ? invalid[static_cast<size_t>(env) * A + a]
                                  : 0.f;
    if (env >= wa.B) continue;
    const Tree t = tree(i);
    const float rv = root_value[env];
    for (int j = lane; j < N; j += 32)
      t.node[j] = j == 0 ? make_float4(1.f, rv, 0.f,
                                       puct_scale(1.f, wa.pb_c_init,
                                                  wa.pb_c_base))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = lane; s < K; s += 32) t.cidx[s] = -1;
    for (int j = lane; j < E; j += 32)
      emb(i, 0)[j] = root_emb[static_cast<size_t>(env) * E + j];
    warp_softmax(root_logits + static_cast<size_t>(env) * A, t.cpri, A,
                 lane);
    if (lane == 0) t.path[0] = 0;
  }
  cluster.sync();  // the barriers initialised; every block of the cluster runs
  mz_wide::mbar_wait(bars, 0);

  for (int sim = 0; sim < wa.num_simulations; ++sim) {
    // ---- walk: each env's descent, then its parent's embedding and the
    // leaf's one-hot index into every block of the cluster
    for (int i = warp; i < kRankEnvs; i += kWideWarps) {
      const int env = env0 + i, m = row0 + i;
      if (env >= wa.B) continue;
      const Tree t = tree(i);
      const Leaf leaf = descend(t, A, C, K, wa, inval + i * A, lane);
      // Fresh node sim+1, unless the depth cap stopped on an existing child.
      const int slot = leaf.child < 0 ? sim + 1 : leaf.child;
      if (leaf.child < 0)
        for (int s = lane; s < K; s += 32)
          t.cidx[static_cast<size_t>(slot) * K + s] = -1;
      const float* pe = emb(i, leaf.parent);
      for (int j = lane; j < E; j += 32) {
        const float v = pe[j];
        for (int r = 0; r < kC; ++r)
          cluster.map_shared_rank(X, r)[m * wa.ld_x + j] = v;
      }
      if (lane < kC) cluster.map_shared_rank(hot, lane)[m] = leaf.act;
      if (lane == 0) {
        int* c = ctl + kCtlWords * i;
        c[kWParent] = leaf.parent;
        c[kWAct] = leaf.act;
        c[kWSlot] = slot;
        c[kWDepth] = leaf.depth;
      }
    }
    cluster.sync();

    // ---- the parts: the decision and chance towers, then the prediction
    long q = static_cast<long>(sim) * wa.n_stream;
    for (int p = 0; p < wa.n_parts; ++p) {
      wide_part<kT, kC, kNTW>(wa, st, p, q, X, H, L, red, hot, rank);
      if (p >= wa.n_resident) q += (wa.in8[p] + wa.prow[p] - 1) / wa.prow[p];
      cluster.sync();  // part p is whole where it is read
      if (p != wa.mid) continue;
      // ---- the towers' heads: under a decision parent the afterstate's
      // normaliser, the chance prior's softmax and the value's decode;
      // under a chance parent the reward's decode; the next state's
      // normaliser on every row, in every block
      for (int k = warp; k < 3 * kRankEnvs + kT; k += kWideWarps) {
        if (k >= 3 * kRankEnvs) {
          const int m = k - 3 * kRankEnvs, i = m - row0;
          float* ns = X + m * wa.ld_x;
          const bool mine = i >= 0 && i < kRankEnvs && env0 + i < wa.B &&
                            ctl[kCtlWords * i + kWAct] >= A;
          warp_normalize(ns, mine ? emb(i, ctl[kCtlWords * i + kWSlot]) : ns,
                         E, lane);
          continue;
        }
        const int i = k / 3, sub = k % 3;
        if (env0 + i >= wa.B) continue;
        int* c = ctl + kCtlWords * i;
        float* cf = reinterpret_cast<float*>(c);
        float* l = L + i * wa.ld_l;
        const int slot = c[kWSlot];
        if (c[kWAct] < A) {
          if (sub == 0) {
            warp_normalize(l, emb(i, slot), E, lane);
          } else if (sub == 1) {
            warp_softmax(l + E, tree(i).cpri + static_cast<size_t>(slot) * K,
                         C, lane);
          } else {
            const float value = warp_decode(l + E + C, S41, wa.support, lane);
            if (lane == 0) {
              cf[kWValue] = value;
              cf[kWReward] = 0.f;
            }
          }
        } else if (sub == 0) {
          const float reward = warp_decode(l, S41, wa.support, lane);
          if (lane == 0) cf[kWReward] = reward;
        }
      }
      __syncthreads();
    }

    // ---- the prediction's decodes, the install and the backup
    for (int k = warp; k < 2 * kRankEnvs; k += kWideWarps) {
      const int i = k % kRankEnvs;
      if (env0 + i >= wa.B) continue;
      int* c = ctl + kCtlWords * i;
      float* cf = reinterpret_cast<float*>(c);
      const Tree t = tree(i);
      const int act = c[kWAct], slot = c[kWSlot];
      if (k < kRankEnvs) {
        const float value =
            act < A ? cf[kWValue]
                    : warp_decode(L + i * wa.ld_l + A, S41, wa.support, lane);
        install_backup(t, slot, c[kWParent], act, c[kWDepth], value,
                       &cf[kWReward], A, K, wa, lane);
      } else if (act >= A) {
        warp_softmax(L + i * wa.ld_l, t.cpri + static_cast<size_t>(slot) * K,
                     A, lane);
      }
    }
    __syncthreads();
  }

  // ---- the root summary of each env
  for (int i = warp; i < kRankEnvs; i += kWideWarps) {
    const int env = env0 + i;
    if (env >= wa.B) continue;
    const Tree t = tree(i);
    const size_t e = static_cast<size_t>(env);
    for (int a = lane; a < A; a += 32) {
      const int c = t.cidx[a];
      out_visits[e * A + a] = c >= 0 ? t.node[c].x : 0.f;
      out_q[e * A + a] = c >= 0 ? t.node[c].y : 0.f;
    }
    if (lane == 0) out_value[env] = t.node[0].y;
  }
  cluster.sync();  // no block exits while another may still write into it
}

// ---- the wide kernel's launch ----------------------------------------------

// The instances: tile rows kT, blocks kC a cluster, and the column tiles a
// warp can own in a part (kNTW).
using WideKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, char*, float*, float*,
                            float*, const WideArgs);

WideKernel wide_kernel(int tile, int cluster, int* ntw) {
  if (tile == 16 && cluster == 16) {
    *ntw = 1;
    return fused_smz_wide_kernel<16, 16, 1>;
  }
  if (tile == 48 && cluster == 4) {
    *ntw = 3;
    return fused_smz_wide_kernel<48, 4, 3>;
  }
  return nullptr;
}

// Fills the parts, the pack's layout and the shared memory's from the
// shapes and the plan (tile rows, cluster blocks, the resident prefix of
// parts, the ring's slots); returns 0, or kErrShape where a part has more
// column tiles than the instance's warps can own or the shapes pass the
// kernel's limits. search/fused.py `smz_wide_layout` repeats the
// arithmetic for the plan.
int wide_layout(WideArgs* wa, int B, int A, int C, int E, int S41,
                int num_simulations, int max_depth, int n_dec,
                const int* dec_width, int n_ch, const int* ch_width,
                int n_pred, const int* pred_width, int tile, int cluster,
                int ntw, int n_resident, int ring) {
  if (n_dec < 1 || n_dec > kMaxLayers || n_ch < 1 || n_ch > kMaxLayers ||
      n_pred < 1 || n_pred > kMaxLayers || B < 1 || A < 1 || C < 1 ||
      E < 1 || S41 < 1 || num_simulations < 1 ||
      num_simulations + 1 > kMaxNodes || A > kMaxNodes || C > kMaxNodes ||
      max_depth < 1 || ring < 0 || ring > kMaxRing)
    return kErrShape;
  wa->B = B;
  wa->A = A;
  wa->C = C;
  wa->K = A > C ? A : C;
  wa->E = E;
  wa->S41 = S41;
  wa->num_simulations = num_simulations;
  wa->max_depth = max_depth;
  wa->num_nodes = num_simulations + 1;
  // Each tower's parts in turn: the decision tower, the
  // chance tower, the prediction tower. Hidden layer l reads X (l = 0) or
  // the buffer layer l - 1 wrote; the heads read the last hidden layer's.
  int n = 0, hidden = 1;
  auto tower = [&](int nl, const int* widths, int heads, int kind, int hot) {
    for (int l = 0; l <= nl; ++l) {
      const int in = l == 0 ? E : widths[l - 1];
      wa->in[n] = in;
      wa->in8[n] = (in + 7) / 8 * 8;
      wa->width[n] = l < nl ? widths[l] : heads;
      wa->nb[n] = ((wa->width[n] + cluster - 1) / cluster + 7) / 8 * 8;
      wa->src[n] = l == 0 ? kBufX : kBufH0 + (l - 1) % 2;
      wa->kind[n] = l < nl ? kHidden : kind;
      wa->dst[n] = kBufH0 + l % 2;
      wa->hot[n] = l == 0 ? hot : kHotNone;
      if (l < nl && widths[l] > hidden) hidden = widths[l];
      ++n;
    }
  };
  tower(n_dec, dec_width, E + C + S41, kDecHeads, kHotAction);
  tower(n_ch, ch_width, E + S41, kChHeads, kHotOutcome);
  wa->mid = n - 1;
  tower(n_pred, pred_width, A + S41, kPredHeads, kHotNone);
  wa->n_parts = n;
  if (n_resident < 0 || n_resident > n || (n_resident < n && ring < 2))
    return kErrShape;
  // The pack of a rank: each part's biases and one-hot rows, then each
  // part's weights; the staged prefix ends after the resident parts'.
  int fixed = 0, slot_nb = 0;
  for (int p = 0; p < n; ++p) {
    if (mz_wide::warp_tiles(wa->nb[p]) > ntw) return kErrShape;
    wa->b_off[p] = fixed;
    fixed += wa->nb[p];
    wa->h_off[p] = fixed;
    fixed += wa->nb[p] * (wa->hot[p] == kHotAction    ? A
                          : wa->hot[p] == kHotOutcome ? C
                                                      : 0);
    if (p >= n_resident && wa->nb[p] > slot_nb) slot_nb = wa->nb[p];
  }
  long weights = (fixed + 7) / 8 * 8;
  for (int p = 0; p < n; ++p) {
    if (weights > INT_MAX / 2) return kErrShape;
    wa->w_off[p] = static_cast<int>(weights);
    weights += static_cast<long>(wa->in8[p]) * wa->nb[p];
  }
  if (weights > INT_MAX / 2) return kErrShape;
  wa->rank_floats = static_cast<int>(weights);
  wa->res_floats = n_resident < n ? wa->w_off[n_resident] : wa->rank_floats;
  wa->n_resident = n_resident;
  // A slot holds kPieceRows rows of the widest streamed part; a narrower
  // part's pieces take as many rows (a multiple of 8) as fill it.
  wa->slot_floats = kPieceRows * slot_nb;
  wa->ring = n_resident < n ? ring : 0;
  int pieces = 0;
  for (int p = 0; p <= n; ++p) {
    wa->spiece0[p] = pieces;
    if (p == n) break;
    wa->prow[p] = wa->in8[p];
    if (slot_nb > 0) {
      const int rows = wa->slot_floats / wa->nb[p] / 8 * 8;
      wa->prow[p] = rows < 8 ? 8 : (rows < wa->in8[p] ? rows : wa->in8[p]);
    }
    if (p >= n_resident) pieces += (wa->in8[p] + wa->prow[p] - 1) / wa->prow[p];
  }
  wa->n_stream = pieces;
  auto row = [](int k) { return (k + 31) / 32 * 32 + 4; };
  wa->ld_x = row(E);
  wa->ld = row(hidden);
  const int logits = E + C + S41 > A + S41 ? E + C + S41 : A + S41;
  wa->ld_l = row(logits);
  const int N = num_simulations + 1;
  const int P = (max_depth < num_simulations ? max_depth : num_simulations) + 1;
  wa->tree_bytes = tree_bytes_of(N, wa->K, P);
  wa->tree_base = round16(4L * B * N * E);
  const int envs = tile / cluster;
  bool split = false;  // a part whose warps split its k-steps
  for (int p = 0; p < n; ++p) split |= mz_wide::k_split(wa->nb[p] / 8) > 1;
  long cur = kBarrierFloats;
  auto take = [&](long floats) {
    const long at = cur;
    cur += (floats + 3) / 4 * 4;
    return static_cast<int>(at);
  };
  take(wa->res_floats);
  wa->s_ring = take(static_cast<long>(wa->ring) * wa->slot_floats);
  wa->s_x = take(static_cast<long>(tile) * wa->ld_x);
  wa->s_h0 = take(static_cast<long>(tile) * wa->ld);
  wa->s_h1 = take(static_cast<long>(tile) * wa->ld);
  wa->s_l = take(static_cast<long>(envs) * wa->ld_l);
  wa->s_red = take(split ? kWideWarps * (tile / 16) * 128L : 0);
  wa->s_inval = take(static_cast<long>(envs) * A);
  wa->s_ctl = take(static_cast<long>(envs) * kCtlWords);
  wa->s_hot = take(tile);
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

// The launch of the wide kernel over ceil(B / tile) clusters.
int launch_wide(const WideArgs& wa, int tile, int cluster,
                const float* root_emb, const float* root_logits,
                const float* root_value, const float* invalid,
                const float* pack, char* scratch, float* out_visits,
                float* out_value, float* out_q, int device, void* stream) {
  int ntw = 0;
  const WideKernel kernel = wide_kernel(tile, cluster, &ntw);
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
                           invalid, pack, scratch, out_visits, out_value,
                           out_q, wa);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one environment's parts, for a check of the launch plan's
// layout: out[0] the compact tree, out[1] the work buffers, out[2] the
// embeddings.
void mz_smz_env_bytes(int A, int C, int E, int S41, int num_simulations,
                      int max_depth, int max_hidden, long* out) {
  const int N = num_simulations + 1;
  const int K = A > C ? A : C;
  const int P = (max_depth < num_simulations ? max_depth : num_simulations)
                + 1;
  out[0] = tree_bytes_of(N, K, P);
  out[1] = 4L * work_floats_of(A, C, E, S41, max_hidden);
  out[2] = round16(4L * N * E);
}

// Launch the Stochastic MuZero search on `stream`. Inputs are env-major and
// contiguous f32: root_emb [B, E], root_logits [B, A] (the decision logits,
// noised and masked), root_value [B], invalid [B, A] or NULL. weights is the
// flat buffer of the three towers, per linear W [in, out] then b [out]: the
// decision tower's hidden layers (the first on E + A inputs), afterstate
// head [H, E], chance head [H, C], value head [H, S41]; the chance tower's
// hidden layers (the first on E + C), next-state head [H, E], reward head
// [H, S41]; the prediction tower's hidden layers (the first on E), policy
// head [H, A], value head [H, S41]. The launch plan (search/fused.py
// `smz_search_plan`): envs_per_block environments a block, the trees in
// shared memory or not (smem_tree), the embeddings in shared memory or not
// (smem_emb), smem_bytes of shared memory a block (the towers, staged once,
// then each environment's) and scratch_bytes of device scratch (scratch,
// per environment the tree where it is not in shared memory, then the
// embeddings where they are not). Outputs: visits
// [B, A], value [B], q [B, A]. Returns a cudaError_t, or MZ_ERR_SHAPE when
// the shapes or the plan do not fit the kernel.
int mz_fused_smz_search(const float* root_emb, const float* root_logits,
                        const float* root_value, const float* invalid,
                        const float* weights, int n_weights, void* scratch,
                        long scratch_bytes, int envs_per_block, int smem_tree,
                        int smem_emb, long smem_bytes,
                        float* out_visits, float* out_value, float* out_q,
                        int B, int A, int C,
                        int E, int S41, int support, int num_simulations,
                        int max_depth, float discount, float pb_c_init,
                        float pb_c_base, int n_dec, const int* dec_width,
                        int n_ch, const int* ch_width, int n_pred,
                        const int* pred_width, int device, void* stream) {
  if (n_dec < 1 || n_dec > kMaxLayers || n_ch < 1 || n_ch > kMaxLayers ||
      n_pred < 1 || n_pred > kMaxLayers || B < 1 || A < 1 || C < 1 ||
      E < 1 || S41 < 1 || num_simulations < 1 ||
      num_simulations + 1 > kMaxNodes || A > kMaxNodes || C > kMaxNodes ||
      max_depth < 1 ||
      envs_per_block < 1 || envs_per_block > kMaxEnvs ||
      (smem_emb && !smem_tree))
    return kErrShape;
  Args g;
  g.B = B;
  g.A = A;
  g.C = C;
  g.K = A > C ? A : C;
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
  int max_hidden = 1;
  for (int l = 0; l < n_dec; ++l) {
    g.dec_width[l] = dec_width[l];
    if (dec_width[l] > max_hidden) max_hidden = dec_width[l];
  }
  for (int l = 0; l < n_ch; ++l) {
    g.ch_width[l] = ch_width[l];
    if (ch_width[l] > max_hidden) max_hidden = ch_width[l];
  }
  for (int l = 0; l < n_pred; ++l) {
    g.pred_width[l] = pred_width[l];
    if (pred_width[l] > max_hidden) max_hidden = pred_width[l];
  }
  const int dec_heads[3] = {E, C, S41};
  const int ch_heads[2] = {E, S41};
  const int pred_heads[2] = {A, S41};
  const long dec = tower_floats(E + A, dec_width, n_dec, dec_heads, 3);
  const long ch = tower_floats(E + C, ch_width, n_ch, ch_heads, 2);
  const long pred = tower_floats(E, pred_width, n_pred, pred_heads, 2);
  if (dec + ch + pred != n_weights) return kErrShape;
  g.ch_offset = static_cast<int>(dec);
  g.pred_offset = static_cast<int>(dec + ch);
  g.n_weights = n_weights;
  g.weights_stride = (n_weights + 3) / 4 * 4;
  g.max_hidden = max_hidden;
  long parts[3];
  mz_smz_env_bytes(A, C, E, S41, num_simulations, max_depth, max_hidden,
                   parts);
  g.tree_bytes = parts[0];
  g.work_floats = static_cast<int>(parts[1] / 4);
  g.emb_bytes = parts[2];
  g.env_smem_bytes = parts[1] + (smem_tree ? parts[0] : 0) +
                     (smem_emb ? parts[2] : 0);
  g.env_scratch_bytes = (smem_tree ? 0 : parts[0]) + (smem_emb ? 0 : parts[2]);
  g.envs_per_block = envs_per_block;
  g.smem_emb = smem_emb;
  // The plan's sizes must be the kernel's.
  const long smem = 4L * g.weights_stride + envs_per_block * g.env_smem_bytes;
  if (smem != smem_bytes || scratch_bytes < B * g.env_scratch_bytes ||
      (g.env_scratch_bytes > 0 && scratch == nullptr))
    return kErrShape;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > max_smem) return kErrShape;
  auto kernel = smz_instance(smem_tree);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (B + envs_per_block - 1) / envs_per_block;
  kernel<<<grid, kEnvThreads * envs_per_block, smem,
           static_cast<cudaStream_t>(stream)>>>(
      root_emb, root_logits, root_value, invalid, weights,
      static_cast<char*>(scratch), out_visits, out_value, out_q, g);
  return cudaGetLastError();
}

// Blocks of the plan that one SM of `device` holds at once, as the CUDA
// runtime reckons it from the compiled kernel (its registers included).
int mz_smz_blocks_per_sm(int envs_per_block, int smem_tree, long smem_bytes,
                         int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = smz_instance(smem_tree);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, kEnvThreads * envs_per_block,
      static_cast<size_t>(smem_bytes));
}

// Launch the Stochastic MuZero search with towers wider than a block's
// shared memory (fused_smz_wide_kernel) on `stream`. Inputs and outputs as
// mz_fused_smz_search; pack: the towers cut by columns for each of the
// `cluster` ranks (search/fused.py `pack_smz_wide_towers`; pack_floats =
// cluster x mz_smz_wide_layout's out[1]); scratch: the embeddings [B, N,
// E], then the compact trees. The plan (search/fused.py `smz_wide_plan`):
// tiles of `tile` envs on clusters of `cluster` blocks (16 x 16 or 48 x 4),
// the first n_resident parts staged in shared memory and the rest streamed
// through `ring` slots. Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_smz_wide_search(
    const float* root_emb, const float* root_logits, const float* root_value,
    const float* invalid, const float* pack, long pack_floats, void* scratch,
    long scratch_bytes, int tile, int cluster, int n_resident, int ring,
    float* out_visits, float* out_value,
    float* out_q, int B, int A, int C, int E, int S41, int support,
    int num_simulations, int max_depth, float discount, float pb_c_init,
    float pb_c_base, int n_dec, const int* dec_width, int n_ch,
    const int* ch_width, int n_pred, const int* pred_width, int device,
    void* stream) {
  int ntw = 0;
  if (wide_kernel(tile, cluster, &ntw) == nullptr) return kErrShape;
  WideArgs wa;
  const int bad = wide_layout(&wa, B, A, C, E, S41, num_simulations,
                              max_depth, n_dec, dec_width, n_ch, ch_width,
                              n_pred, pred_width, tile, cluster, ntw,
                              n_resident, ring);
  if (bad) return bad;
  if (pack_floats != static_cast<long>(cluster) * wa.rank_floats ||
      scratch == nullptr || scratch_bytes < wa.tree_base + B * wa.tree_bytes)
    return kErrShape;
  wa.support = support;
  wa.discount = discount;
  wa.pb_c_init = pb_c_init;
  wa.pb_c_base = pb_c_base;
  return launch_wide(wa, tile, cluster, root_emb, root_logits, root_value,
                     invalid, pack, static_cast<char*>(scratch), out_visits,
                     out_value, out_q, device, stream);
}

// The wide kernel's layout for the plan (arguments as
// mz_fused_smz_wide_search): out = {shared memory bytes a block, floats of
// a rank's pack, floats of its staged prefix, streamed pieces a
// simulation, floats of a ring slot, bytes of a tree, parts, the part after
// which the decision and chance heads are whole}.
int mz_smz_wide_layout(int B, int A, int C, int E, int S41,
                       int num_simulations, int max_depth, int n_dec,
                       const int* dec_width, int n_ch, const int* ch_width,
                       int n_pred, const int* pred_width, int tile,
                       int cluster, int n_resident, int ring, long* out) {
  int ntw = 0;
  if (wide_kernel(tile, cluster, &ntw) == nullptr) return kErrShape;
  WideArgs wa;
  const int bad = wide_layout(&wa, B, A, C, E, S41, num_simulations,
                              max_depth, n_dec, dec_width, n_ch, ch_width,
                              n_pred, pred_width, tile, cluster, ntw,
                              n_resident, ring);
  if (bad) return bad;
  out[0] = 4L * wa.smem_floats;
  out[1] = wa.rank_floats;
  out[2] = wa.res_floats;
  out[3] = wa.n_stream;
  out[4] = wa.slot_floats;
  out[5] = wa.tree_bytes;
  out[6] = wa.n_parts;
  out[7] = wa.mid;
  return 0;
}

// Clusters of the wide kernel (tile rows x cluster blocks, smem_bytes of
// shared memory a block) that the card holds at once, as the CUDA runtime
// reckons it (cudaOccupancyMaxActiveClusters); into *out.
int mz_smz_wide_active_clusters(int tile, int cluster, long smem_bytes,
                                int device, int* out) {
  int ntw = 0;
  const WideKernel kernel = wide_kernel(tile, cluster, &ntw);
  if (kernel == nullptr) return kErrShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const int bad = wide_config(kernel, cluster, static_cast<size_t>(smem_bytes),
                              cluster, nullptr, &config, &attr);
  if (bad) return bad;
  return cudaOccupancyMaxActiveClusters(out, kernel, &config);
}

const char* mz_smz_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused Stochastic MuZero search kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
