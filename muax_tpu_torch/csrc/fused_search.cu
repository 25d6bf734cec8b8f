// Fused MuZero PUCT search: every simulation of every environment in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel muax_tpu/search/fused.py `_make_kernel` with
// policy="muzero", decode="h_support" and elu towers, which `_fused_search`
// launches through pl.pallas_call (muax_tpu/search/fused.py:759). The plain
// PyTorch version of the same function is `fused_muzero_search_reference`
// in muax_tpu_torch/search/fused.py.
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
// the root value; root priors are softmax(noised logits); PUCT under the
// parent-and-siblings qtransform with invalid actions masked at depth 0 only;
// the first maximum wins; the descent stops at an unexpanded child or at
// max_depth, and a depth-capped descent re-evaluates the existing child in
// place; expansion is dynamics + prediction with h-support decode and a
// min-max normalised next state; the install is a running mean; the backup
// starts from the raw network value.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxEnvsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr float kHEps = 1e-3f;

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

__global__ void __launch_bounds__(32 * kMaxEnvsPerBlock)
fused_muzero_search_kernel(const float* __restrict__ root_emb,
                           const float* __restrict__ root_logits,
                           const float* __restrict__ root_value,
                           const float* __restrict__ invalid,
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
  float* nvis = smem + args.weights_stride + warp * args.env_floats;
  float* nval = nvis + N;
  int* npar = reinterpret_cast<int*>(nval + N);
  int* nact = npar + N;
  int* cidx = nact + N;
  float* cpri = reinterpret_cast<float*>(cidx + NA);
  float* cvis = cpri + NA;
  float* crew = cvis + NA;
  float* cval = crew + NA;
  float* emb = cval + NA;
  float* bufs[2] = {emb + N * E, emb + N * E + args.act_width};
  float* inval = bufs[1] + args.act_width;

  // ---- forest init ------------------------------------------------------
  const float rv = root_value[env];
  for (int i = lane; i < N; i += 32) {
    nvis[i] = i == 0 ? 1.f : 0.f;
    nval[i] = i == 0 ? rv : 0.f;
    npar[i] = -1;
    nact[i] = -1;
  }
  for (int i = lane; i < NA; i += 32) {
    cidx[i] = -1;
    cpri[i] = 0.f;
    cvis[i] = 0.f;
    crew[i] = 0.f;
    cval[i] = 0.f;
  }
  for (int j = lane; j < E; j += 32)
    emb[j] = root_emb[static_cast<size_t>(env) * E + j];
  for (int a = lane; a < A; a += 32)
    inval[a] = invalid ? invalid[static_cast<size_t>(env) * A + a] : 0.f;
  softmax_into(root_logits + static_cast<size_t>(env) * A, cpri, A, lane);

  for (int sim = 0; sim < args.num_simulations; ++sim) {
    // ---- descent: PUCT under the parent-and-siblings qtransform ---------
    int cur = 0, parent = -1, act = -1, depth = 0;
    while (true) {
      const float nvisit = nvis[cur];
      const float nvalue = nval[cur];
      const int row = cur * A;
      float lo = INFINITY, hi = -INFINITY;
      for (int a = lane; a < A; a += 32) {
        const float q = crew[row + a] + discount * cval[row + a];
        const float safe_q = cvis[row + a] > 0.f ? q : nvalue;
        lo = fminf(lo, safe_q);
        hi = fmaxf(hi, safe_q);
      }
      const float minv = fminf(nvalue, warp_min(lo));
      const float maxv = fmaxf(nvalue, warp_max(hi));
      const float span = fmaxf(maxv - minv, 1e-8f);
      const float pb_c =
          args.pb_c_init + logf((nvisit + args.pb_c_base + 1.f) / args.pb_c_base);
      const float prior_scale = sqrtf(nvisit) * pb_c;
      float best = -INFINITY;
      int best_a = INT_MAX;
      for (int a = lane; a < A; a += 32) {
        const float cv = cvis[row + a];
        const float q = crew[row + a] + discount * cval[row + a];
        const float completed = cv > 0.f ? q : minv;
        float score =
            (completed - minv) / span + prior_scale * cpri[row + a] / (cv + 1.f);
        if (depth == 0 && inval[a] > 0.f) score = kNeg;
        if (score > best) {  // a rises along the lane's stride: first max
          best = score;
          best_a = a;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oa = __shfl_xor_sync(kFull, best_a, o);
        if (ob > best || (ob == best && oa < best_a)) {
          best = ob;
          best_a = oa;
        }
      }
      const int child = cidx[row + best_a];
      parent = cur;
      act = best_a;
      cur = child;
      ++depth;
      if (child < 0 || depth >= args.max_depth) break;
    }
    // Fresh node sim+1, unless the depth cap stopped on an existing child.
    const int edge = parent * A + act;
    const int existing = cidx[edge];
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
    softmax_into(bufs[k], cpri + slot * A, A, lane);

    // ---- install (running mean) and backup along parent pointers -------
    if (lane == 0) {
      const float count = nvis[slot];
      nval[slot] = (nval[slot] * count + value) / (count + 1.f);
      nvis[slot] = count + 1.f;
      npar[slot] = parent;
      nact[slot] = act;
      crew[edge] = reward;
      cidx[edge] = slot;
      int idx = slot;
      float v = value;  // the raw network value, as in the TPU kernel
      while (idx != 0) {
        const int par = npar[idx];
        const int e = par * A + nact[idx];
        const float cnt = nvis[par];
        const float vnew = crew[e] + discount * v;
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

  // ---- root summary ------------------------------------------------------
  for (int a = lane; a < A; a += 32) {
    out_visits[static_cast<size_t>(env) * A + a] = cvis[a];
    out_q[static_cast<size_t>(env) * A + a] = crew[a] + discount * cval[a];
  }
  if (lane == 0) out_value[env] = nval[0];
}

}  // namespace

// Returned when the shapes do not fit the kernel (too many layers, or one
// environment's tree does not fit the shared memory of a block).
#define MZ_ERR_SHAPE (-1)

extern "C" {

// Launch the search on `stream`. Inputs are env-major and contiguous f32:
// root_emb [B, E], root_logits [B, A] (noised and masked), root_value [B],
// invalid [B, A] or NULL; weights is the flat tower buffer (per layer W
// [in, out] then b [out]: dynamics hidden layers, reward head, next-state
// head, then prediction hidden layers, value head, policy head). Outputs:
// visits [B, A], value [B], q [B, A]. Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_muzero_search(const float* root_emb, const float* root_logits,
                           const float* root_value, const float* invalid,
                           const float* weights, int n_weights,
                           float* out_visits, float* out_value, float* out_q,
                           int B, int A, int E, int S41, int support_size,
                           int num_simulations, int max_depth, float discount,
                           float pb_c_init, float pb_c_base, int n_dyn,
                           const int* dyn_width, int n_pred,
                           const int* pred_width, int device, void* stream) {
  if (n_dyn < 1 || n_dyn > kMaxLayers || n_pred < 1 || n_pred > kMaxLayers ||
      B < 1 || A < 1 || E < 1 || S41 < 1 || num_simulations < 1)
    return MZ_ERR_SHAPE;
  Args args;
  args.B = B;
  args.A = A;
  args.E = E;
  args.S41 = S41;
  args.support_size = support_size;
  args.num_simulations = num_simulations;
  args.max_depth = max_depth;
  args.num_nodes = num_simulations + 1;
  args.discount = discount;
  args.pb_c_init = pb_c_init;
  args.pb_c_base = pb_c_base;
  args.n_dyn = n_dyn;
  args.n_pred = n_pred;
  int act_width = E + A;
  if (S41 > act_width) act_width = S41;
  long dyn_floats = 0;
  int in = E + A;
  for (int l = 0; l < n_dyn; ++l) {
    args.dyn_width[l] = dyn_width[l];
    if (dyn_width[l] > act_width) act_width = dyn_width[l];
    dyn_floats += static_cast<long>(in) * dyn_width[l] + dyn_width[l];
    in = dyn_width[l];
  }
  dyn_floats += static_cast<long>(in) * (S41 + E) + S41 + E;
  long pred_floats = 0;
  in = E;
  for (int l = 0; l < n_pred; ++l) {
    args.pred_width[l] = pred_width[l];
    if (pred_width[l] > act_width) act_width = pred_width[l];
    pred_floats += static_cast<long>(in) * pred_width[l] + pred_width[l];
    in = pred_width[l];
  }
  pred_floats += static_cast<long>(in) * (S41 + A) + S41 + A;
  if (dyn_floats + pred_floats != n_weights) return MZ_ERR_SHAPE;
  args.pred_offset = static_cast<int>(dyn_floats);
  args.n_weights = n_weights;
  args.weights_stride = (n_weights + 3) / 4 * 4;
  args.act_width = act_width;
  const long N = num_simulations + 1;
  args.env_floats =
      static_cast<int>(4 * N + 5 * N * A + N * E + 2 * act_width + A);

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
  if (per_block == 0) return MZ_ERR_SHAPE;
  args.envs_per_block = per_block;
  const size_t smem =
      (static_cast<size_t>(args.weights_stride) +
       static_cast<size_t>(per_block) * args.env_floats) * sizeof(float);
  err = cudaFuncSetAttribute(fused_muzero_search_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (B + per_block - 1) / per_block;
  fused_muzero_search_kernel<<<grid, 32 * per_block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      root_emb, root_logits, root_value, invalid, weights, out_visits,
      out_value, out_q, args);
  return cudaGetLastError();
}

const char* mz_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes do not fit the fused search kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
