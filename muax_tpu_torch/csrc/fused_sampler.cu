// Fused replay sampler: window-start draw and window extraction for W
// windows in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel muax_tpu/replay/fused_sampler.py
// `_make_sampler_kernel` in both its modes, which `fused_sample_group`
// launches through pl.pallas_call (muax_tpu/replay/fused_sampler.py:280):
// per_step_obs=False (the start observation, for the learner kernel) and
// per_step_obs=True (the observation at every window step, row f*K + j, for
// the hybrid feed of the families without a learner kernel).
// The plain PyTorch version of the same function is
// `fused_sample_group_reference` in muax_tpu_torch/replay/fused_sampler.py.
//
// What bounds it on this card. Per window it does a few dozen operations
// and moves about 420 bytes (its segment index, num_starts Gumbels and
// priorities, the start observation (f32 or, for pixel rings, uint8), K actions, rewards, returns and dones,
// K*A policy entries, the segment's target step, and 40 output rows), so it
// is bound by bytes: about 28 MB per launch of 65,536 windows, 8 us at
// 3.35 TB/s. With per_step_obs it also reads and writes K observations per
// window (O*K more rows). The reads of the ring are scattered (each window
// lands in a random segment); the writes are not.
//
// What the design does about it. A group of kGroup = 8 lanes owns a
// window, a block of 256 threads 32 windows. The group reads the segment's
// num_starts priorities (contiguous: 64 bytes at L = 20, K = 5) and their
// Gumbels in one pass of its lanes and takes the first maximum in three
// shuffle rounds; then each lane owns steps j = lane, lane + 8, ... of the
// window and copies that step's contiguous entries (its observation with
// per_step_obs, action, reward, return, policy row, done) into their rows.
// The rows are stored window-fastest, so a row's stores from the four
// groups of a warp are one 16-byte run. The TPU kernel keeps the whole ring
// in VMEM and gathers it with a one-hot matmul because XLA's gather was
// slow there; here the lanes index the ring directly in its [C, L, ...]
// layout and read only what the window needs. The ring (about 2 MB at the
// training regime) stays in the 50 MB L2 across the group.
//
// Semantics are those of the TPU kernel: start = first argmax over the
// num_starts = L - K + 1 valid starts of log(prio + 1e-9) + gumbel; step j
// is valid iff no done lies strictly before it in the window; denom =
// max(sum(mask), 1); the padding rows after the target-step row are zero.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;  // lanes of one window
constexpr int kThreads = 256;
constexpr int kWindows = kThreads / kGroup;  // windows of one block

struct Layout {
  int obs, action, reward, rn, pi, mask, start, weight, denom, tstep, rows;
};

// ObsT is the ring's observation type, float or uint8_t (pixel frames);
// each element is converted to f32 as it is written into its raw row.
template <typename ObsT>
__global__ void __launch_bounds__(kThreads) fused_sample_group_kernel(
    const ObsT* __restrict__ obs, const int* __restrict__ action,
    const float* __restrict__ reward, const float* __restrict__ rn,
    const float* __restrict__ pi, const uint8_t* __restrict__ done,
    const float* __restrict__ prios, const int* __restrict__ tstep,
    const int64_t* __restrict__ seg_idx, const float* __restrict__ gumbel,
    float* __restrict__ raw, int C, int L, int O, int A, int K, int W,
    int per_step_obs, Layout lay) {
  const int w = blockIdx.x * kWindows + threadIdx.x / kGroup;
  if (w >= W) return;  // the whole group
  const int lane = threadIdx.x % kGroup;
  const unsigned group = 0xffu << (threadIdx.x % 32 / kGroup * kGroup);
  const size_t ldw = static_cast<size_t>(W);
  auto out = [&](int row, float v) { raw[row * ldw + w] = v; };

  const int64_t seg = seg_idx[w];
  if (seg < 0 || seg >= C) {
    // Outside the ring: nothing is read; the window is all zeros.
    for (int r = lane; r < lay.rows; r += kGroup) out(r, 0.f);
    return;
  }
  const size_t base = static_cast<size_t>(seg) * L;

  // Start: first maximum of log(prio + 1e-9) + gumbel over valid starts,
  // the lanes over the starts, then the group (ties to the lower start).
  const int num_starts = L - K + 1;
  float best = -INFINITY;
  int start = INT_MAX;
  for (int s = lane; s < num_starts; s += kGroup) {
    const float v = logf(prios[base + s] + 1e-9f) + gumbel[s * ldw + w];
    if (v > best) {
      best = v;
      start = s;
    }
  }
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(group, best, o);
    const int os = __shfl_xor_sync(group, start, o);
    if (ob > best || (ob == best && os < start)) {
      best = ob;
      start = os;
    }
  }
  if (start == INT_MAX) start = 0;  // no start scored above -inf
  const size_t t0 = base + start;

  // Each lane's steps of the window.
  float valid = 0.f;  // whole numbers: the sum is exact in any order
  for (int j = lane; j < K; j += kGroup) {
    const size_t t = t0 + j;
    if (per_step_obs) {  // row f*K + j: feature f of step j
      for (int f = 0; f < O; ++f)
        out(lay.obs + f * K + j, static_cast<float>(obs[t * O + f]));
    }
    out(lay.action + j, static_cast<float>(action[t]));
    out(lay.reward + j, reward[t]);
    out(lay.rn + j, rn[t]);
    for (int a = 0; a < A; ++a) out(lay.pi + j * A + a, pi[t * A + a]);
    float m = 1.f;  // step j is valid iff no done lies strictly before it
    for (int i = 0; i < j; ++i)
      if (done[t0 + i]) m = 0.f;
    out(lay.mask + j, m);
    valid += m;
  }
  if (!per_step_obs) {
    for (int f = lane; f < O; f += kGroup)
      out(lay.obs + f, static_cast<float>(obs[t0 * O + f]));
  }
  for (int o = kGroup / 2; o > 0; o >>= 1)
    valid += __shfl_xor_sync(group, valid, o);
  if (lane == 0) {
    out(lay.start, static_cast<float>(start));
    out(lay.weight, prios[t0]);
    out(lay.denom, fmaxf(valid, 1.f));
    out(lay.tstep, static_cast<float>(tstep[seg]));
  }
  for (int r = lay.tstep + 1 + lane; r < lay.rows; r += kGroup) out(r, 0.f);
}

}  // namespace

#define MZ_ERR_SHAPE (-1)

// The ring's observation type, as mz_fused_sample_group's obs_dtype.
#define MZ_OBS_F32 0
#define MZ_OBS_U8 1

extern "C" {

// Launch the sampler on `stream`. The ring is row-major: obs [C, L, O] f32
// (obs_dtype MZ_OBS_F32) or uint8 (MZ_OBS_U8), action [C, L] i32, reward and rn [C, L] f32, pi [C, L, A] f32, done
// [C, L] bool (one byte), prios [C, L] f32, tstep [C] i32. seg_idx [W] i64,
// gumbel [L, W] f32 (rows past num_starts are not read). raw [rows, W] f32
// gets every row of the layout: O observation rows from r_obs, or O*K with
// per_step_obs. Returns a cudaError_t, or MZ_ERR_SHAPE.
int mz_fused_sample_group(const void* obs, int obs_dtype, const int* action,
                          const float* reward, const float* rn,
                          const float* pi, const uint8_t* done,
                          const float* prios, const int* tstep,
                          const int64_t* seg_idx, const float* gumbel,
                          float* raw, int C, int L, int O, int A, int K, int W,
                          int per_step_obs, int r_obs, int r_action,
                          int r_reward, int r_rn, int r_pi, int r_mask,
                          int r_start, int r_weight, int r_denom, int r_tstep,
                          int rows, void* stream) {
  if (C < 1 || L < 1 || O < 1 || A < 1 || K < 1 || K > L || W < 1 ||
      rows <= r_tstep || (obs_dtype != MZ_OBS_F32 && obs_dtype != MZ_OBS_U8))
    return MZ_ERR_SHAPE;
  const Layout lay{r_obs, r_action, r_reward, r_rn, r_pi, r_mask,
                   r_start, r_weight, r_denom, r_tstep, rows};
  const int grid = (W + kWindows - 1) / kWindows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (obs_dtype == MZ_OBS_U8)
    fused_sample_group_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(obs), action, reward, rn, pi, done,
        prios, tstep, seg_idx, gumbel, raw, C, L, O, A, K, W, per_step_obs,
        lay);
  else
    fused_sample_group_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(obs), action, reward, rn, pi, done, prios,
        tstep, seg_idx, gumbel, raw, C, L, O, A, K, W, per_step_obs, lay);
  return cudaGetLastError();
}

const char* mz_sampler_error_string(int code) {
  if (code == MZ_ERR_SHAPE)
    return "shapes or the obs dtype do not fit the fused sampler";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
