"""Where the time of the search and learner kernels goes, on one CUDA card.

Run from the root of a checkout (its ``muax_tpu_torch`` package and
``csrc/`` are the ones measured):

  python3 tools/kernel_split.py [--out FILE]
      [--only mlp|learner|categorical|smz|sampler|wide|wide_smz|digests]
      [--against OTHER]

The MLP search (``fused_search_kernel``, both policies) is timed at 8192
and 1024 envs x 64 simulations at the flagship widths (A = 2, embedding 8,
support 20, hidden (16,)), with CUDA events, as its plan launches it and
with each lane-group size G; then a copy of its source
with per-warp ``clock64()`` stamps at the kernel's section comments (the
descent, the expansion, the install and backup) and around the Gumbel mode's
mix value gives each section's share of the warp-cycles (lane 0 of each
warp stamps; the mix value's share is part of the descent's). Then its
wide mode at ``examples/run_2048.py``'s widths (``fused_search_wide_kernel``
for towers past a block's shared memory; in a checkout before it, the
global-weight instance) at 64 and 1024 boards x 50 simulations on phase
30's roots, both policies: CUDA events, then a stamped copy's cycles of
each section (the walk, each phase of products, the decodes, the install
and backup; per block, or per warp in the older instance) and their
shares.

The MLP learner (``--only learner``) is timed at batch 4096 and the
flagship widths (embedding 8, support 20, hidden (16,), K = 5; a seeded
batch with masks) with CUDA events, each of its kernels with
``torch.profiler``, and set against float64 as the categorical learner is
(below); with its launch plan and theoretical warps per SM. A copy of its
source with ``clock64()`` stamps gives each section's share of the tile
pass's block-cycles (the forward with the staging of the weights; the
backward, with the prediction tower's weight gradients on the warps its
stages leave idle; the other weight gradients) and the share of the
stages of tile products; the finish pass, which adds the blocks' rows, is
a kernel of its own, timed by the profiler. Then the wide learner (batch
256, K = 5, phase 30's windows): CUDA events, each kernel's device time,
and the shares of a stamped copy (the cluster pass's forward and
backward, or the older tile pass's sections). ``--only wide`` runs the two
wide cases alone, and the Stochastic MuZero search's wide towers
(``--only wide_smz`` alone): chip_smoke.py phase 33's launches at 64 and
1024 boards x 200 simulations, the search's own plan, the tile kernel's
plan and every other layout of it that fits (CUDA events and a digest of
the outputs each), then a stamped copy's cycles a simulation of the walk,
each part (and of its product and epilogue) and the decodes.

For the categorical family it times the learner at batch 1024 (``categorical_training``'s
batch, bench widths: embedding 64, towers (256, 256, 256), 51 bins) and the
tiled search at 2048 and 512 envs x 64 simulations in both policies, with
CUDA events and, by kernel, with ``torch.profiler`` (the search also with
each cluster size it can take). Then it builds a copy
of the two sources under ``build/split/`` with ``clock64()`` stamps added at
the kernels' section comments (the forward, the backward and, where the
kernel has it, the dW section of the learner; the descent, the towers and
the install of the search) and around each tile product, and prints each
section's share of the block-cycles and the products' share within it.
The stamps add a barrier at each mark, so the shares, not the stamped
times, are the figures to read.

The Stochastic MuZero search (``--only smz``) is timed (CUDA events, and
its device time with ``torch.profiler``) at bench.py's smz_mlp widths and
stochastic_200sims regime on a fresh net, on the same net trained by the
port's own ``fit`` (40 iterations of stochastic_200sims, about 25 s on the
card, cached under ``build/smz_trained/`` and reused when present), the
trained net with ``max_depth=32`` and at 512 envs, a deep-tree net (the
fresh net with +8 on one entry of the policy head's and of the chance
head's bias) with and without ``max_depth=32``, and the fresh and trained
nets on 64 roots (one environment an SM); with its launch plan and
ptxas's registers, stack frame and spills. A stamped copy gives the
descent depths (mean and largest), each section's share of the
environments' leader-warp cycles (setup, descent, expansion, install and
backup, summary) and the cycles of a level of the descent, of an
expansion and of a backup. The sampler (``--only sampler``) is timed as
phases 4 and 18 call it (W = 65,536, and W = 16,384 with per_step_obs):
the wrapper with CUDA events in five runs of 20 calls, the host's time a
call, and each launch's device time (``torch.profiler``, least, median
and largest of 50), with its bound.

Last it sets the learner's priorities and gradients against the plain
version in float64: the largest error of the kernel and of the plain
version in float32, each relative to the float64 result. The stamps are
placed by the sources' section comments and lines, which an edit to those
lines must keep.

With ``--against OTHER`` (the root of another checkout, such as the parent
commit unpacked with ``git archive``) it instead compares the two
checkouts, each run a fresh process with its checkout's own package (and
``chip_smoke.py``), after both have built their kernels: first a digest of
the outputs of every staged and categorical instance, the staged SMZ
search's, the wide MLP search's and both sampler modes' (``DIGEST_RUN``;
``digests_equal`` says which agree; ``--only digests`` stops there), then
the MLP learner
as above (CUDA events, each kernel, a digest of its outputs) and the
categorical learner at batch 1024 (CUDA events, each kernel), the MLP
learner's
priorities at embedding 32 against the plain version in float32 and in
float64 (``priority_probe``, once per checkout), then the MLP
training iterations, ``chip_smoke.py``'s phases 6 and 10, each in the order
other, this, this, other. ``--only learner`` keeps the learner alone;
``--only mlp`` takes the MLP search on trees too large for many to fit the
card at once (8192 envs, 18 actions x 64 simulations and 2 x 400, the
``gpu`` tests' inputs) against the plain version, with a digest of the
kernel's outputs that shows whether the two kernels round alike, in place
of the learner; ``--only smz`` and ``--only sampler`` time those kernels
alone at the points above (the SMZ search with a digest of its outputs),
in the same order; ``--only wide_smz`` times the wide SMZ search as each
checkout's plan launches it on phase 33's roots at 64, 112 and 1024
boards x 200 simulations, and at 64 boards on two other sets of roots, in
five rounds of that order (ten runs of each checkout).
"""
import argparse
import copy
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

BENCH = dict(embedding_dim=64, num_bins=51, vmin=-150.0, vmax=150.0,
             layer_sizes=(256, 256, 256))

PRE = r'''
__device__ unsigned long long g_sec[4096 * 8];
__device__ unsigned long long g_gemm_cycles[4096];
template <typename... Ts> __device__ void timed_gemm(Ts... a) {
  __syncthreads();
  long long s = clock64();
  GEMM(a...);
  __syncthreads();
  if (threadIdx.x == 0) g_gemm_cycles[blockIdx.x] += clock64() - s;
}
#define STAMP(k) { __syncthreads(); if (threadIdx.x == 0) { \
  long long _n = clock64(); \
  unsigned long long _g = g_gemm_cycles[blockIdx.x]; \
  g_sec[blockIdx.x * 8 + (k)] += _n - _last; \
  g_sec[blockIdx.x * 8 + 4 + (k)] += _g - _lastg; \
  _last = _n; _lastg = _g; } }
#define STAMP_INIT long long _last = clock64(); \
  unsigned long long _lastg = g_gemm_cycles[blockIdx.x];
'''
POST = r'''
extern "C" int split_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_sec);
  cudaMemset(p, 0, sizeof(g_sec));
  cudaGetSymbolAddress(&p, g_gemm_cycles);
  return cudaMemset(p, 0, sizeof(g_gemm_cycles));
}
extern "C" int split_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_sec, sizeof(g_sec));
}
'''


# The MLP search's stamps: lane 0 of each warp keeps its own section sums
# in registers and adds them at the end; the mix value adds its cycles to
# the warp's slot.
MLP_PRE = r'''
__device__ unsigned long long g_msec[4];
__device__ unsigned long long g_mix[1 << 17];
#define MSTAMP_INIT long long _last = clock64(); \
  unsigned long long _acc[3] = {0, 0, 0};
#define MSTAMP(k) { long long _n = clock64(); _acc[k] += _n - _last; \
  _last = _n; }
#define MSTAMP_FLUSH if ((threadIdx.x & 31) == 0) { \
  for (int _k = 0; _k < 3; ++_k) atomicAdd(&g_msec[_k], _acc[_k]); }
#define MIX_START const long long _ms = clock64();
#define MIX_END if ((threadIdx.x & 31) == 0) \
  g_mix[((blockIdx.x * blockDim.x + threadIdx.x) >> 5) & ((1 << 17) - 1)] \
  += clock64() - _ms;
'''
MLP_POST = r'''
extern "C" int split_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_msec);
  cudaMemset(p, 0, sizeof(g_msec));
  cudaGetSymbolAddress(&p, g_mix);
  return cudaMemset(p, 0, sizeof(g_mix));
}
extern "C" int split_read(unsigned long long* out) {
  unsigned long long* mix = new unsigned long long[1 << 17];
  int err = cudaMemcpyFromSymbol(out, g_msec, sizeof(g_msec));
  if (!err) err = cudaMemcpyFromSymbol(mix, g_mix, sizeof(g_mix));
  out[3] = 0;
  for (int i = 0; i < (1 << 17); ++i) out[3] += mix[i];
  delete[] mix;
  return err;
}
'''
MLP_SECTIONS = ("descent", "expansion", "install_backup", "mix_value")
_MLP_INCLUDE = '#include "group_mlp.cuh"\n'
_MLP_MIX_END = ("  m.span = fmaxf(hi - lo, 1e-8f);\n"
                "  m.scale = (kMaxvisitInit + maxvisit) * kValueScale;\n")
MLP_MARKS = [
    (_MLP_INCLUDE, _MLP_INCLUDE + MLP_PRE),
    ("  for (int sim = 0; sim < args.num_simulations; ++sim) {\n",
     "  MSTAMP_INIT\n"
     "  for (int sim = 0; sim < args.num_simulations; ++sim) {\n"),
    ("    // ---- descent ---", "    MSTAMP(2)\n    // ---- descent ---"),
    ("    // ---- expansion:", "    MSTAMP(0)\n    // ---- expansion:"),
    ("    // ---- install (running mean)",
     "    MSTAMP(1)\n    // ---- install (running mean)"),
    ("    g.sync();\n  }\n\n  // ---- the root summary",
     "    g.sync();\n  }\n  MSTAMP(2)\n  MSTAMP_FLUSH\n\n"
     "  // ---- the root summary"),
    ("  const int* kids = t.cidx + node * A;\n",
     "  MIX_START\n  const int* kids = t.cidx + node * A;\n"),
    (_MLP_MIX_END, _MLP_MIX_END + "  MIX_END\n")]


def _one(src, old, new):
  if src.count(old) != 1:
    raise RuntimeError(f"mark not found once: {old!r}")
  return src.replace(old, new)


def _stamped(src, marks, gemm):
  """The source with PRE after its tile-product include, each
  ``mz_tc::gemm`` through timed_gemm where `gemm` is true, the section
  marks and POST."""
  include = '#include "tc_tile.cuh"\n'
  if gemm:
    src = src.replace("mz_tc::gemm(", "timed_gemm(")
  src = _one(src, include, include + PRE.replace("GEMM", "mz_tc::gemm"))
  for old, new in marks:
    src = _one(src, old, new)
  return src + POST


# The learner's per-tile kernel: its forward, then its backward.
LEARNER_SECTIONS = ("forward", "backward")
_LEARNER_START = ("  float* ce = base + g.ce;   // [3, K*T] value, policy, "
                  "reward CE; [T] v0\n")
_LEARNER_END = ("  cat_tower_bwd(rp, weights, base, 0, T, dx0, dx1, nullptr, 0,"
                " warp, lane);\n}")
LEARNER_MARKS = [
    (_LEARNER_START, _LEARNER_START + "  STAMP_INIT\n"),
    ("  // ---- backward: prediction over every step ----------------------"
     "----------\n  for (int r = warp; r < KT; r += kCatWarps) {",
     "  STAMP(0)\n  // backward\n"
     "  for (int r = warp; r < KT; r += kCatWarps) {"),
    (_LEARNER_END, _LEARNER_END[:-1] + "  STAMP(1)\n}")]

# The search's simulation loop (the initialisation is not stamped); the
# products inside cluster_layer are warp 0's time.
SEARCH_SECTIONS = ("install_backup_summary", "descent", "towers")
_SEARCH_LOOP = "  for (int sim = 0; sim < g.num_simulations; ++sim) {\n"
_SEARCH_END = "  }\n}\n\n// Sizes the shared memory from"
SEARCH_MARKS = [
    (_SEARCH_LOOP, "  STAMP_INIT\n" + _SEARCH_LOOP),
    ("    // ---- descent, and the dynamics input", "    STAMP(0)\n    //"),
    ("    // ---- dynamics: hidden layers, reward head", "    STAMP(1)\n    //"),
    ("    // ---- install and backup, one warp per environment",
     "    STAMP(2)\n    //"),
    (_SEARCH_END, "  }\n  STAMP(0)\n}\n\n// Sizes the shared memory from"),
    ("  mz_tc::product<1, 1, false>(\n",
     "  long long _s = clock64();\n  mz_tc::product<1, 1, false>(\n"),
    ("      warp, kTileWarps);\n}\n",
     "      warp, kTileWarps);\n  if (threadIdx.x == 0) "
     "g_gemm_cycles[blockIdx.x] += clock64() - _s;\n}\n")]


# The MLP learner's tile pass (mlp_tile_kernel): block stamps at its
# sections (the forward, with the staging of the weights; the backward,
# with the prediction tower's weight gradients on idle warps; the other
# weight-gradient products and column sums), and each stage of products
# timed by thread 0 from its start to its barrier's end.
TILE_LEARNER_SECTIONS = ("forward", "backward", "weight_gradients")
_STAGE_END = ("  if (warp >= t1 + t2) idle(warp - t1 - t2, kWarps - t1 - t2);\n"
              "  __syncthreads();\n}\n")
_KERNEL_END = ("  weight_grads(0, pred_dw_early ? l_pred0 : l_dyn0, l_dyn0, g.n_lin, "
               "warp,\n               kWarps);\n}\n")
TILE_LEARNER_MARKS = [
    ("                                      const Idle& idle) {\n",
     "                                      const Idle& idle) {\n"
     "  const long long _g0 = clock64();\n"),
    (_STAGE_END, _STAGE_END[:-2] + "  if (threadIdx.x == 0) "
     "g_gemm_cycles[blockIdx.x] += clock64() - _g0;\n}\n"),
    ("  float* ce = base + g.ce;\n\n",
     "  float* ce = base + g.ce;\n  STAMP_INIT\n\n"),
    ("  stage<kPrefA>(prod(R, g.din[l_value], bwd_term(l_value, 0),",
     "  STAMP(0)\n  stage<kPrefA>(prod(R, g.din[l_value], "
     "bwd_term(l_value, 0),"),
    ("  // ---- weight gradients: the block's row of partial",
     "  STAMP(1)\n  // ---- weight gradients: the block's row of partial"),
    (_KERNEL_END, _KERNEL_END[:-2] + "  STAMP(2)\n}\n")]


def _mlp_stamped(src):
  for old, new in MLP_MARKS:
    src = _one(src, old, new)
  return src + MLP_POST


def build_stamped(build, which):
  """Stamped copies of the sources, built with nvcc: the learner's and the
  categorical search's (``which`` "categorical"), the MLP search's
  ("mlp"); returns (libraries, section names) by stamped copy."""
  from muax_tpu_torch import _build
  csrc = pathlib.Path(_build.__file__).parent / "csrc"
  out = pathlib.Path(build)
  out.mkdir(parents=True, exist_ok=True)
  for header in csrc.glob("*.cuh"):
    shutil.copy(header, out / header.name)
  names, procs = {}, {}
  jobs = {"categorical": (
      ("fused_learner", "fused_learner",
       lambda s: _stamped(s, LEARNER_MARKS, True), LEARNER_SECTIONS),
      ("fused_search", "fused_search",
       lambda s: _stamped(s, SEARCH_MARKS, False), SEARCH_SECTIONS)),
          "mlp": (("fused_search_mlp", "fused_search", _mlp_stamped,
                   MLP_SECTIONS),),
          "learner": (("fused_learner_mlp", "fused_learner",
                       lambda s: _stamped(s, TILE_LEARNER_MARKS, False),
                       TILE_LEARNER_SECTIONS),),
          "smz": (("fused_smz_split", "fused_smz", _smz_stamped,
                   SMZ_SECTIONS),),
          "wide": (("fused_search_wide", "fused_search", _wide_stamped,
                    ()),),
          "wide_learner": (("fused_learner_wide", "fused_learner",
                            _wide_learner_stamped, ()),),
          "wide_smz": (("fused_smz_wide", "fused_smz", _wide_smz_stamped,
                        ()),)}
  for key in which:
    for name, source, stamp, names[name] in jobs[key]:
      src = (csrc / f"{source}.cu").read_text()
      (out / f"{name}.cu").write_text(stamp(src))
      procs[name] = subprocess.Popen(
          [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
           str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  libs = {}
  for name, proc in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f"nvcc failed on the stamped {name}.cu:\n{log}")
    libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    libs[name].split_read.argtypes = [ctypes.c_void_p]
  return libs, names


def events_ms(fn, reps):
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def by_kernel_ms(fn, reps):
  """Device time per call of each kernel that ``fn`` launches."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  return {e.key[:60]: e.self_device_time_total / 1e3 / reps
          for e in prof.key_averages() if e.self_device_time_total > 0}


def _stamped_run(name, source, fn, libs, size):
  """Run ``fn`` with the stamped copy ``name`` in place of ``source``'s
  library; returns the stamped counters."""
  from muax_tpu_torch import _build
  plain = _build.load(source)
  _build._loaded[source] = libs[name]
  try:
    libs[name].split_reset()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * size)()
    libs[name].split_read(ctypes.addressof(buf))
  finally:
    _build._loaded[source] = plain
  return buf


def mlp_shares(fn, libs):
  """Each section's share of the MLP search's warp-cycles; the mix value's
  is part of the descent's."""
  buf = _stamped_run("fused_search_mlp", "fused_search", fn, libs, 4)
  whole = sum(buf[:3])
  return {s: buf[k] / whole for k, s in enumerate(MLP_SECTIONS)}


def shares(name, fn, libs, names, source=None):
  """Each section's share of the stamped kernel's block-cycles, and the
  products' share within it (both of the whole); ``source``: the library
  the stamped copy ``name`` stands in for (``name`` by default)."""
  buf = _stamped_run(name, source or name, fn, libs, 4096 * 8)
  tot = [sum(buf[b * 8 + k] for b in range(4096)) for k in range(8)]
  n = len(names[name])
  whole = sum(tot[:n])
  return ({s: tot[k] / whole for k, s in enumerate(names[name])},
          {s: tot[4 + k] / whole for k, s in enumerate(names[name])})


def learner_case(dev, B=1024, A=2, K=5, family="categorical",
                 embedding_dim=8, support=20, repr_layers=(16,),
                 layers=(16,), param_seed=1, data_seed=0):
  """The learner's inputs: the categorical family at the bench widths (B =
  1024, categorical_training's batch), or with ``family="mlp"`` the MLP
  triplet (the flagship by default: embedding 8, support 20, hidden
  (16,)); a seeded batch of B windows with masks."""
  from muax_tpu_torch.models import (fused_learner,
                                     make_categorical_mlp_networks,
                                     make_mlp_networks)
  from muax_tpu_torch.types import Transition
  if family == "mlp":
    net = make_mlp_networks(A, embedding_dim=embedding_dim,
                            support_size=support, repr_layers=repr_layers,
                            pred_layers=layers, dyn_layers=layers,
                            device=dev)
    reward_scale, rn_scale = 1.0, 5.0
  else:
    net = make_categorical_mlp_networks(A, device=dev, **BENCH)
    reward_scale, rn_scale = 3.0, 40.0
  params = net.init_params((4,), torch.Generator().manual_seed(param_seed))
  gen = torch.Generator(device=dev).manual_seed(data_seed)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=dev)
  batch = Transition(
      obs=torch.randn((B, K, 4), generator=gen, device=dev),
      action=torch.randint(0, A, (B, K), generator=gen, device=dev),
      reward=torch.randn((B, K), generator=gen, device=dev) * reward_scale,
      done=torch.zeros((B, K), dtype=torch.bool, device=dev),
      rn=torch.randn((B, K), generator=gen, device=dev) * rn_scale,
      value=torch.zeros((B, K), device=dev),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen, device=dev), -1),
      weight=torch.rand((B,), generator=gen, device=dev) + 0.5,
      mask=(torch.arange(K, device=dev)[None] < lengths[:, None]).float())
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  return net, params, raw, coef, lay


def accuracy(net, params, raw, coef, lay):
  """Largest error of the kernel's and of the float32 plain version's
  priorities and gradients, relative to the plain version in float64
  (gradients: relative to the largest float64 gradient)."""
  from muax_tpu_torch.models import fused_learner
  kw = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
  lw = fused_learner.extract_learner(net, params)
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, lw, **kw)
  ref_grads, ref = fused_learner.fused_muzero_grad_raw_reference(
      params, raw, coef, lay, net, **kw)
  g64, m64 = fused_learner.fused_muzero_grad_raw_reference(
      copy.deepcopy(params).double(), raw.double(), coef.double(), lay, net,
      **kw)
  scale = float(g64.abs().max())

  def rel(a, b):
    return float(((a.double() - b).abs() / b.abs().clamp(min=1e-30)).max())

  return {"kernel": {"priorities_rel": rel(metrics.priorities, m64.priorities),
                     "grads_of_max": float((grads.double() - g64).abs().max())
                     / scale},
          "plain_f32": {"priorities_rel": rel(ref.priorities, m64.priorities),
                        "grads_of_max": float((ref_grads.double() - g64)
                                              .abs().max()) / scale}}


# The priority probe's MLP cases at embedding 32: (A, representation
# hidden, towers, support, K), each at seeds 0-3 for the parameters and the
# batch (drawn as the ``gpu`` tests draw them), B = 300.
PROBE_CASES = {"A3_H24_S10_K4": (3, (16,), (24,), 10, 4),
               "A2_H16_S20_K5": (2, (16,), (16,), 20, 5)}


def priority_probe(dev, B=300):
  """The MLP learner at embedding 32 (``PROBE_CASES``): for each case and
  seed, the share of the priority check's tolerance (rtol = atol = 1e-4)
  that the kernel uses against the float32 plain version, and that the
  kernel and the float32 plain version each use against the float64 plain
  version: the largest over the windows, and the three at each window
  where one of them passes 0.5."""
  from muax_tpu_torch.models import fused_learner
  kw = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)

  def used(a, b):
    a, b = a.double(), b.double()
    return (a - b).abs() / (1e-4 + 1e-4 * b.abs())

  out = {}
  for name, (A, repr_layers, layers, support, K) in PROBE_CASES.items():
    for seed in range(4):
      net, params, raw, coef, lay = learner_case(
          dev, B=B, A=A, K=K, family="mlp", embedding_dim=32,
          support=support, repr_layers=repr_layers, layers=layers,
          param_seed=seed, data_seed=seed)
      lw = fused_learner.extract_learner_weights(net, params)
      _, got = fused_learner.fused_muzero_grad_raw(params, raw, coef, lay,
                                                   net, lw, **kw)
      _, ref = fused_learner.fused_muzero_grad_raw_reference(
          params, raw, coef, lay, net, **kw)
      _, r64 = fused_learner.fused_muzero_grad_raw_reference(
          copy.deepcopy(params).double(), raw.double(), coef.double(), lay,
          net, **kw)
      p, q, q64 = got.priorities, ref.priorities, r64.priorities
      each = torch.stack([used(p, q), used(p, q64), used(q, q64)])
      worst = each.amax(1)
      out[f"{name}_seed{seed}"] = {
          "kernel_vs_plain": float(worst[0]), "kernel_vs_f64": float(
              worst[1]), "plain_vs_f64": float(worst[2]),
          "windows": {int(w): [float(x) for x in each[:, w]]
                      for w in torch.nonzero(each.amax(0) > 0.5)[:, 0]}}
  return out


def search_case(dev, B, policy):
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_categorical_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn
  net = make_categorical_mlp_networks(2, device=dev, **BENCH)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  gen = torch.Generator(device=dev).manual_seed(0)
  _, obs = CartPole().reset(gen, B)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  kw = dict(num_simulations=64, discount=0.997, invalid_actions=None,
            max_depth=None)
  if policy == "gumbel":
    logits = root.prior_logits.contiguous()
    kw["root_score"], kw["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel_noise(gen, logits.shape, dev), None,
        max_num_considered_actions=16, num_simulations=64)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          fused.extract_search_weights(net, params))
  return lambda: fused._fused_search_cuda(*args, **kw)


def mlp_case(dev, B, policy):
  """The MLP search at the flagship widths on B CartPole roots."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn
  net = make_mlp_networks(2, embedding_dim=8, support_size=20, device=dev)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  gen = torch.Generator(device=dev).manual_seed(0)
  _, obs = CartPole().reset(gen, B)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  kw = dict(num_simulations=64, discount=0.997, invalid_actions=None,
            max_depth=None, support_size=20)
  if policy == "gumbel":
    logits = root.prior_logits.contiguous()
    kw["root_score"], kw["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel_noise(gen, logits.shape, dev), None,
        max_num_considered_actions=16, num_simulations=64)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          fused.extract_search_weights(net, params))
  return lambda: fused._fused_search_cuda(*args, **kw)


def mlp_split(res, build):
  """The MLP search's times and section shares, both policies, at 8192 and
  1024 envs."""
  from muax_tpu_torch.search import fused
  cases = {f"mlp_{p}_{B}": mlp_case(torch.device("cuda", 0), B, p)
           for B in (8192, 1024) for p in ("muzero", "gumbel")}
  chosen = fused.mlp_search_plan
  for key, fn in cases.items():
    res[key] = {"ms": events_ms(fn, 10)}
    for group in fused.MLP_GROUPS:  # each lane-group size, for the record
      fused.mlp_search_plan = lambda *a, group=group, **kw: chosen(
          *a, group=group, **kw)
      try:
        res[key][f"ms_group_{group}"] = events_ms(fn, 10)
      finally:
        fused.mlp_search_plan = chosen
  print(json.dumps(res), flush=True)
  libs, _ = build_stamped(build, ["mlp"])
  for key, fn in cases.items():
    res[key]["sections"] = mlp_shares(fn, libs)
  wide_split(res, build)


def learner_split(res, dev, build):
  """The MLP learner at batch 4096 and the flagship widths: ms per launch
  with CUDA events and each of its kernels with torch.profiler, its
  accuracy against float64, then each section's share from a stamped
  copy."""
  from muax_tpu_torch.models import fused_learner
  net, params, raw, coef, lay = learner_case(dev, B=4096, family="mlp")
  lw = fused_learner.extract_learner_weights(net, params)

  def learn():
    return fused_learner._grad_cuda(lw, raw, coef, lay, l2_coef=1e-4,
                                    gradient_scale=0.5)

  out = res["mlp_learner"] = {
      "ms": events_ms(learn, 50), "by_kernel_ms": by_kernel_ms(learn, 20),
      "accuracy": accuracy(net, params, raw, coef, lay)}
  from muax_tpu_torch.device import device_limits
  plan = fused_learner.mlp_learner_plan(raw.shape[1], lay.K, lw,
                                        device_limits(dev))
  per_sm = fused_learner.learner_blocks_per_sm(plan, dev)
  out["plan"] = plan._asdict()
  out["theoretical_warps_per_sm"] = min(
      per_sm, -(-plan.blocks // torch.cuda.get_device_properties(
          dev).multi_processor_count)) * fused_learner.LEARNER_THREADS // 32
  print(json.dumps(res), flush=True)
  libs, names = build_stamped(build, ["learner"])
  out["sections"], out["products"] = shares(
      "fused_learner_mlp", learn, libs, names, "fused_learner")
  wide_learner_split(res, dev, build)


# The MLP learner in a checkout: its ms per launch (CUDA events), each
# kernel's (torch.profiler) and a digest of its outputs, on learner_case's
# inputs (this file's, imported from TOOLS; the package is the checkout's).
LEARNER_RUN = r'''
import hashlib, json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
from muax_tpu_torch.models import fused_learner
torch.backends.cuda.matmul.allow_tf32 = False
net, params, raw, coef, lay = ks.learner_case(torch.device("cuda", 0),
                                              B=4096, family="mlp")
lw = fused_learner.extract_learner_weights(net, params)
fn = lambda: fused_learner._grad_cuda(lw, raw, coef, lay, l2_coef=1e-4,
                                      gradient_scale=0.5)
digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                 for t in fn())).hexdigest()[:16]
cnet, cparams, craw, ccoef, clay = ks.learner_case(torch.device("cuda", 0))
spec = fused_learner.extract_categorical_learner_spec(cnet, cparams)
cfn = lambda: fused_learner._grad_cuda(spec, craw, ccoef, clay,
                                       l2_coef=1e-4, gradient_scale=0.5)
print("LEARNER " + json.dumps({"ms": ks.events_ms(fn, 50),
                               "by_kernel_ms": ks.by_kernel_ms(fn, 20),
                               "outputs_sha256": digest,
                               "categorical_ms": ks.events_ms(cfn, 20),
                               "categorical_by_kernel_ms":
                                   ks.by_kernel_ms(cfn, 10)}))
'''.replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))
PRIORITY_RUN = r'''
import json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
torch.backends.cuda.matmul.allow_tf32 = False
print("PRIORITIES " + json.dumps(ks.priority_probe(torch.device("cuda", 0))))
'''.replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))
ITERATION_RUN = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device("cuda", 0)
out = {}
for policy in ("muzero", "gumbel"):
  t = chip_smoke.training_setup(device, policy)
  chip_smoke.fill_ring(t)
  _, fig = chip_smoke.drive_training(device, t)
  out[policy] = {k: fig[k] for k in ("iteration_ms", "rollout_ms",
                                     "learner_ms")}
  out[policy]["device_idle_share"] = fig["profile"].get("device_idle_share")
print("ITERATION " + json.dumps(out))
'''
LARGE_TREE_RUN = r'''
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.inference import make_root_fn
dev, B = torch.device("cuda", 0), 8192
out = {}
for A, sims in ((18, 64), (2, 400)):
  net = make_mlp_networks(A, embedding_dim=8, support_size=20,
                          pred_layers=(16,), dyn_layers=(16,), device=dev)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  gen = torch.Generator(device=dev).manual_seed(1)
  _, obs = CartPole().reset(gen, B)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs * 20)
  args = (root.embedding.contiguous(), root.prior_logits.contiguous(),
          root.value.contiguous(), fused.extract_fused_weights(net, params))
  kw = dict(num_simulations=sims, support_size=20, discount=0.997,
            invalid_actions=None, max_depth=None)
  gumbel = gumbel_noise(gen, (B, A), dev)
  score, sched = fused.gumbel_root_inputs(
      args[1], gumbel, None, max_num_considered_actions=16,
      num_simulations=sims)
  for policy in ("muzero", "gumbel"):
    if policy == "muzero":
      got = fused.fused_muzero_search(*args, **kw)
      ref = fused.fused_muzero_search_reference(*args, **kw)
    else:
      got = fused.fused_gumbel_search(*args, gumbel=gumbel,
                                      max_num_considered_actions=16, **kw)
      ref = fused.fused_gumbel_search_reference(
          *args, root_score=score, schedule=sched, **kw)
    (v, val, q), (rv, rval, rq) = got, ref
    dv = (v - rv).abs().amax(-1)
    near, same = dv <= 2, dv == 0
    bad_val = near & ~torch.isclose(val, rval, rtol=1e-3, atol=1e-3)
    bad_q = same & ~torch.isclose(q, rq, rtol=1e-3, atol=1e-3).all(-1)
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in got)).hexdigest()[:16]
    out[f"{policy}_A{A}_sims{sims}"] = dict(
        within_2_visits=float(near.float().mean()), max_visit_diff=float(
            dv.max()), value_apart_envs=int(bad_val.sum()),
        q_apart_envs=int(bad_q.sum()), kernel_outputs_sha256=digest)
print("LARGE " + json.dumps(out))
'''
BUILD_RUN = ("import sys; sys.path.insert(0, '.'); "
             "from muax_tpu_torch import _build; _build.build_all()")


def against(other, only=None):
  """``other`` and the cwd's checkout, each building its kernels first,
  both at once. The MLP learner (``LEARNER_RUN``, then once per checkout
  ``priority_probe``) unless ``only`` is
  "mlp"; with ``only="mlp"`` the MLP search at 8192 envs with 18 actions x
  64 simulations and 2 actions x 400, both policies, against the plain
  version (the share within 2 visits, the envs whose value or q are apart,
  a digest of the kernel's outputs), once per checkout; then, unless
  ``only`` is "learner", phases 6 and 10. With ``only="smz"`` the SMZ
  search at SMZ_POINTS (``smz_times``, on the net trained once here), with
  ``only="sampler"`` both sampler modes (``sampler_times``), with
  ``only="wide_smz"`` the wide SMZ search as its plan launches it at
  WIDE_SMZ_AB_POINTS (``wide_smz_times``; WIDE_SMZ_ROUNDS rounds, each
  checkout's figures also sorted by point), and nothing else. Every timed
  run goes in the order other, this, this, other, and is labelled with its
  checkout."""
  roots = {"other": os.path.abspath(other), "this": os.getcwd()}
  builds = [subprocess.Popen([sys.executable, "-c", BUILD_RUN], cwd=root)
            for root in roots.values()]
  if any(b.wait() for b in builds):
    raise RuntimeError("a checkout's kernels did not build")
  def child(label, code, tag):
    proc = subprocess.run([sys.executable, "-c", code], cwd=roots[label],
                          capture_output=True, text=True)
    line = [l for l in proc.stdout.splitlines() if l.startswith(tag + " ")]
    if proc.returncode or not line:
      raise RuntimeError(f"the {label} checkout's run failed:\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    run = {"checkout": label, **json.loads(line[0][len(tag) + 1:])}
    print(json.dumps(run), flush=True)
    return run

  order = ("other", "this", "this", "other")
  out = {}
  if only not in ("smz", "sampler", "wide_smz"):
    runs = [child(label, DIGEST_RUN, "DIGESTS") for label in roots]
    out["digests"] = runs
    out["digests_equal"] = {k: runs[0][k] == runs[1][k]
                            for k in runs[0] if k != "checkout"}
    if only == "digests":
      return out
  if only == "smz":
    trained_smz_params(torch.device("cuda", 0))  # trained once, for both
    code = SMZ_RUN.replace("TRAINED", repr(os.path.abspath(SMZ_TRAINED)))
    out["smz"] = [child(label, code, "SMZ") for label in order]
    return out
  if only == "sampler":
    out["sampler"] = [child(label, SAMPLER_RUN, "SAMPLER")
                      for label in order]
    return out
  if only == "wide_smz":
    runs = [child(label, WIDE_SMZ_RUN, "WIDE_SMZ")
            for _ in range(WIDE_SMZ_ROUNDS) for label in order]
    out["wide_smz"] = runs
    out["wide_smz_ms"] = {
        label: {p: sorted(r[p]["ms"] for r in runs if r["checkout"] == label)
                for p in runs[0] if p != "checkout"} for label in roots}
    return out
  if only in (None, "learner"):
    out["learner"] = [child(label, LEARNER_RUN, "LEARNER") for label in order]
    out["priorities"] = [child(label, PRIORITY_RUN, "PRIORITIES")
                         for label in roots]
  if only == "mlp":
    out["large_trees"] = [child(label, LARGE_TREE_RUN, "LARGE")
                          for label in roots]
  if only in (None, "mlp"):
    out["iterations"] = [child(label, ITERATION_RUN, "ITERATION")
                         for label in order]
  return out


# ---- Stochastic MuZero search (row 4) and the sampler (rows 6a-6b) ------
#
# The search at bench.py's smz_mlp widths (A = 2, C = 32, embedding 32,
# support 20, hidden (64,)) and stochastic_200sims regime (256 envs x 200
# simulations), on CartPole roots, at these points: a fresh net (seed 0),
# the same net trained by the port's own fit (SMZ_TRAIN_ITERATIONS
# iterations of stochastic_200sims, cached in SMZ_TRAINED and reused when
# present), the trained net with max_depth=32 and at 512 envs, and a
# deep-tree net (the fresh net with DEEP_BIAS on one entry of the policy
# head's and of the chance head's bias, so that one action and one outcome
# dominate and the simulations extend one chain), with and without
# max_depth=32; the fresh and trained nets on 64 roots too, where no two
# environments share an SM.
SMZ_SIMS = 200
SMZ_TRAINED = os.path.join("build", "smz_trained", "params.pkl")
SMZ_TRAIN_ITERATIONS = 40
DEEP_BIAS = 8.0
SMZ_POINTS = {"fresh": ("fresh", 256, None), "trained": ("trained", 256, None),
              "trained_depth32": ("trained", 256, 32),
              "trained_512": ("trained", 512, None),
              "deep": ("deep", 256, None), "deep_depth32": ("deep", 256, 32),
              "fresh_64": ("fresh", 64, None),
              "trained_64": ("trained", 64, None)}


def smz_network(dev):
  from muax_tpu_torch.models import make_stochastic_mlp_networks
  return make_stochastic_mlp_networks(
      2, num_chance_outcomes=32, embedding_dim=32, support_size=20,
      hidden=(64,), device=dev)


def deep_tree_params(params, bias=DEEP_BIAS):
  """``params`` with ``bias`` added to the first entry of the policy head's
  and of the chance head's bias (in place; returns ``params``)."""
  with torch.no_grad():
    params.prediction.linears()[-2].bias[0] += bias
    params.decision.linears()[-2].bias[0] += bias
  return params


def trained_smz_params(dev, path=SMZ_TRAINED,
                       iterations=SMZ_TRAIN_ITERATIONS):
  """(params, training record): the smz_mlp nets trained with ``fit`` on
  CartPole in stochastic_200sims' regime (256 envs x 200 simulations x 20
  steps, batch 256, 8 updates an iteration, seed 0), read from ``path``
  when it exists, else trained and written there."""
  import tempfile
  import time

  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.train.checkpoint import load_pytree, save_pytree
  from muax_tpu_torch.train.fit import fit
  net = smz_network(dev)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  if os.path.exists(path):
    saved = load_pytree(path)
    params.load_state_dict({k: torch.from_numpy(v)
                            for k, v in saved["params"].items()})
    return params, dict(saved["record"], cached=True)
  config = MuZeroConfig(
      search=SearchConfig(policy="stochastic", num_simulations=SMZ_SIMS),
      replay=ReplayConfig(capacity=2048, min_fill=64),
      train=TrainConfig(num_envs=256, collect_steps=20, batch_size=256,
                        updates_per_iteration=8, unroll_steps=5,
                        n_bootstrap=10, presample_updates=16))
  os.makedirs(os.path.dirname(path), exist_ok=True)
  lines = []
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=os.path.dirname(path)) as d:
    state, results = fit(CartPole(), net, config, num_iterations=iterations,
                         seed=0, eval_every=iterations, log_every=1,
                         model_dir=d, save_best=False, log_fn=lines.append)
  record = {"iterations": iterations,
            "seconds": time.perf_counter() - t0,
            "loss": [row["loss"] for row in results["history"]],
            "test_G": {row["iteration"]: row["test_G"]
                       for row in results["history"] if "test_G" in row}}
  save_pytree(path, {"params": dict(state.params.state_dict()),
                     "record": record})
  return state.params, dict(record, cached=False)


def smz_inputs(dev, params, B, max_depth=None, seed=0):
  """The search's inputs on B CartPole roots of ``params`` (Dirichlet
  noise from ``seed``), as ``chip_smoke.py``'s phase 16 draws them."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_smz_fns
  net = smz_network(dev)
  gen = torch.Generator(device=dev).manual_seed(seed)
  _, obs = CartPole().reset(gen, B)
  with torch.no_grad():
    root = make_smz_fns(net, 0.997)[0](params, obs)
  args = (root.embedding.contiguous(),
          fused.noised_root_logits(gen, root.prior_logits),
          root.value.contiguous(),
          fused.extract_smz_fused_weights(net, params))
  kwargs = dict(num_simulations=SMZ_SIMS, discount=0.997, support_size=20,
                invalid_actions=None, max_depth=max_depth)
  return args, kwargs


def smz_cases(dev, trained):
  """SMZ_POINTS' launches: name -> a function launching the kernel."""
  from muax_tpu_torch.search import fused
  fresh = smz_network(dev).init_params((4,),
                                       torch.Generator().manual_seed(0))
  nets = {"fresh": fresh, "trained": trained,
          "deep": deep_tree_params(copy.deepcopy(fresh))}
  cases = {}
  for name, (which, B, depth) in SMZ_POINTS.items():
    args, kwargs = smz_inputs(dev, nets[which], B, depth)
    cases[name] = (lambda a=args, k=kwargs: fused._fused_smz_search_cuda(
        *a, pb_c_init=1.25, pb_c_base=19652.0, **k))
  return cases


def smz_device_ms(fn):
  """The search kernel's device time per launch (torch.profiler)."""
  return sum(v for k, v in by_kernel_ms(fn, 3).items() if "smz" in k)


def smz_times(dev, trained_path=SMZ_TRAINED):
  """Each point's ms per launch (CUDA events), device ms (torch.profiler)
  and a digest of the outputs, in a checkout (``--against``)."""
  import hashlib
  trained, _ = trained_smz_params(dev, trained_path)
  out = {}
  for name, fn in smz_cases(dev, trained).items():
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in fn())).hexdigest()[:16]
    out[name] = {"ms": events_ms(fn, 5),
                 "device_ms": smz_device_ms(fn),
                 "outputs_sha256": digest}
  return out


# The SMZ kernel's stamps: lane 0 of an environment's leader warp keeps its
# section sums (setup, descent, expansion, install and backup, summary) in
# registers and adds them at the end, with the descent depth of each
# simulation (edges walked from the root); placed by the source's section
# comments.
SMZ_SECTIONS = ("setup", "descent", "expansion", "install_backup",
                "summary")
SMZ_PRE = r"""
__device__ unsigned long long g_ssec[5];
__device__ unsigned long long g_sdepth[3];  // sum, count, max
#define SSTAMP_INIT long long _last = clock64(); \
  unsigned long long _acc[5] = {0, 0, 0, 0, 0}, _dsum = 0, _dn = 0, _dmax = 0;
#define SSTAMP(k) { long long _n = clock64(); _acc[k] += _n - _last; \
  _last = _n; }
#define SDEPTH(d) { _dsum += (d); _dn += 1; \
  _dmax = (d) > _dmax ? (d) : _dmax; }
#define SFLUSH(leader) if (leader) { \
  for (int _k = 0; _k < 5; ++_k) atomicAdd(&g_ssec[_k], _acc[_k]); \
  atomicAdd(&g_sdepth[0], _dsum); atomicAdd(&g_sdepth[1], _dn); \
  atomicMax(&g_sdepth[2], _dmax); }
"""
SMZ_POST = r"""
extern "C" int split_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_ssec);
  cudaMemset(p, 0, sizeof(g_ssec));
  cudaGetSymbolAddress(&p, g_sdepth);
  return cudaMemset(p, 0, sizeof(g_sdepth));
}
extern "C" int split_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_ssec, sizeof(g_ssec));
  if (!err) err = cudaMemcpyFromSymbol(out + 5, g_sdepth, sizeof(g_sdepth));
  return err;
}
"""
_SMZ_INCLUDE = '#include "warp_mlp.cuh"\n'
SMZ_MARKS = [
    (_SMZ_INCLUDE, _SMZ_INCLUDE + SMZ_PRE),
    ("  extern __shared__ __align__(16) float smem[];\n",
     "  extern __shared__ __align__(16) float smem[];\n  SSTAMP_INIT\n"),
    ("    // ---- descent ---", "    SSTAMP(0)\n    // ---- descent ---"),
    ("    // ---- expansion:",
     "    SSTAMP(1)\n    SDEPTH(depth)\n    // ---- expansion:"),
    ("    // ---- install (running mean)",
     "    SSTAMP(2)\n    // ---- install (running mean)"),
    ("    }\n  }\n\n  // Decision-edge q",
     "    }\n    SSTAMP(3)\n  }\n\n  // Decision-edge q"),
    ("    if (lane == 0) out_value[env] = t.node[0].y;\n  }\n}\n",
     "    if (lane == 0) out_value[env] = t.node[0].y;\n  }\n  SSTAMP(4)\n"
     "  SFLUSH(tid == 0)\n}\n")]


def _smz_stamped(src):
  for old, new in SMZ_MARKS:
    src = _one(src, old, new)
  return src + SMZ_POST


def smz_split(res, dev, build):
  """The SMZ search at SMZ_POINTS: ms per launch (CUDA events) and on the
  device (torch.profiler), the launch plan, ptxas's registers, stack frame
  and spills; then from a stamped copy the descent depths (mean and
  largest), each section's share of the leader warps' cycles and the
  cycles of a level of the descent, of an expansion and of a backup."""
  from muax_tpu_torch.search import fused
  trained, record = trained_smz_params(dev)
  out = res["smz"] = {"trained_net": record}
  cases = smz_cases(dev, trained)
  for name, fn in cases.items():
    out[name] = {"ms": events_ms(fn, 5),
                 "device_ms": smz_device_ms(fn)}
    print(json.dumps({name: out[name]}), flush=True)
  for B in (256, 512):
    args, kwargs = smz_inputs(dev, trained, B)
    plan = fused.smz_launch_plan(args[0], args[3], **kwargs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out[f"plan_{B}"] = dict(plan._asdict(), theoretical_warps_per_sm=min(
        fused.smz_blocks_per_sm(plan, dev), -(-plan.grid // sms))
                            * plan.envs_per_block * fused.SMZ_ENV_THREADS
                            // 32)
  out["ptxas"] = smz_ptxas(build)
  libs, _ = build_stamped(build, ["smz"])
  for name, fn in cases.items():
    buf = _stamped_run("fused_smz_split", "fused_smz", fn, libs, 8)
    whole = sum(buf[:5])
    out[name]["sections"] = {s: buf[k] / whole
                             for k, s in enumerate(SMZ_SECTIONS)}
    out[name]["depth_mean"] = buf[5] / max(buf[6], 1)
    out[name]["depth_max"] = buf[7]
    # Leader-warp cycles: a level of the descent, and per simulation the
    # expansion and the install and backup.
    out[name]["cycles"] = {"descent_level": buf[1] / max(buf[5], 1),
                           "expansion": buf[2] / max(buf[6], 1),
                           "install_backup": buf[3] / max(buf[6], 1),
                           "per_env": whole / SMZ_POINTS[name][1]}


def smz_ptxas(build):
  """ptxas's report on csrc/fused_smz.cu as the package builds it:
  registers, stack frame, spill stores and loads of each kernel."""
  from muax_tpu_torch import _build
  out = pathlib.Path(build)
  out.mkdir(parents=True, exist_ok=True)
  src = pathlib.Path(_build.__file__).parent / "csrc" / "fused_smz.cu"
  proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                         str(out / "libfused_smz_ptxas.so"), str(src)],
                        capture_output=True, text=True, check=True)
  log = proc.stdout + proc.stderr
  figures, entry = {}, None
  for line in log.splitlines():
    found = re.search(r"Compiling entry function '([^']+)'", line)
    if found:
      entry = figures.setdefault(found.group(1), {})
    elif entry is not None and "stack frame" in line:
      nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
      entry.update(stack_frame=nums[0], spill_stores=nums[1],
                   spill_loads=nums[2])
    elif entry is not None and "Used" in line and "registers" in line:
      entry["registers"] = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
  return figures


def sampler_cases(dev):
  """The sampler as phases 4 and 18 call it: W = 65,536 windows from a ring
  filled by two rollouts of training_regime (row 6a), and W = 16,384 with
  per_step_obs from a ring of smz_training's rollouts (row 6b). name ->
  (function, layout, W)."""
  import chip_smoke
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.replay.buffer import gumbel_noise
  cases = {}
  for name, family, W, per_step in (("6a", "mlp", 16 * 4096, False),
                                    ("6b_per_step_obs", "smz", 64 * 256,
                                     True)):
    t = chip_smoke.training_setup(dev, family=family)
    chip_smoke.fill_ring(t)
    seg_idx = fused_sampler.draw_segments(t.rs, t.gen, W)
    gumbel = gumbel_noise(t.gen, (20, W), dev)
    call = (t.rs, seg_idx, gumbel, 5)
    lay = fused_sampler.fused_sample_group(*call, per_step_obs=per_step)[1]
    cases[name] = (lambda c=call, p=per_step:
                   fused_sampler.fused_sample_group(*c, per_step_obs=p),
                   lay, W)
  return cases


def launch_device_us(fn, reps):
  """The device time of each kernel launch ``fn`` makes over ``reps`` calls
  (torch.profiler), in microseconds."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  each = [e.time_range.end - e.time_range.start for e in prof.events()
          if "CUDA" in str(getattr(e, "device_type", ""))
          and "sample_group" in e.name]
  if not each:  # the profiler kept no kernel events: their mean per call
    mean = sum(v for k, v in by_kernel_ms(fn, reps).items()
               if "sample_group" in k)
    each = [mean * 1e3]
  return each


def sampler_times(dev):
  """Each sampler row: the wrapper's ms per call with CUDA events in five
  runs of 20 calls, the host's microseconds per call (200 calls issued
  without a synchronise), and each launch's device time over 50 calls
  (torch.profiler: least, median, largest), with the bound."""
  import statistics
  import time

  import chip_smoke
  out = {}
  for name, (fn, lay, W) in sampler_cases(dev).items():
    wrapper = [events_ms(fn, 20) for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
      fn()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    device = sorted(launch_device_us(fn, 50))
    bound, by = chip_smoke.sampler_bound_ms(lay, W, 20)
    out[name] = {"W": W, "wrapper_ms": wrapper, "host_us_per_call": host_us,
                 "device_ms": {"min": device[0] / 1e3,
                               "median": statistics.median(device) / 1e3,
                               "max": device[-1] / 1e3,
                               "launches": len(device)},
                 "bound_ms": bound, "bound_by": by}
  return out


SMZ_RUN = r"""
import json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
torch.backends.cuda.matmul.allow_tf32 = False
print("SMZ " + json.dumps(ks.smz_times(torch.device("cuda", 0), TRAINED)))
""".replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))
SAMPLER_RUN = r"""
import json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
torch.backends.cuda.matmul.allow_tf32 = False
print("SAMPLER " + json.dumps(ks.sampler_times(torch.device("cuda", 0))))
""".replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=None, help="also write the JSON here")
  parser.add_argument("--build", default="build/split",
                      help="directory for the stamped copies")
  parser.add_argument("--only", choices=("mlp", "learner", "categorical",
                                          "smz", "sampler", "wide",
                                          "wide_smz", "digests"),
                      default=None, help="split only the MLP search, the "
                      "MLP learner, the categorical kernels, the Stochastic "
                      "MuZero search, the sampler, the wide modes or the "
                      "wide SMZ search")
  parser.add_argument("--against", default=None, metavar="OTHER",
                      help="compare the checkout at OTHER with this one "
                      "(the MLP learner and training iterations; with "
                      "--only mlp the large MLP search trees and the "
                      "iterations; with --only smz, sampler or wide_smz "
                      "those kernels) instead")
  opts = parser.parse_args()
  sys.path.insert(0, os.getcwd())  # the checkout measured is the cwd's
  if not torch.cuda.is_available():
    sys.exit("kernel_split: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda", 0)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  res = {"card": card}
  if opts.against:
    if opts.only in ("categorical", "wide"):
      parser.error(f"--against does not compare --only {opts.only}")
    res.update(against(opts.against, opts.only))
  else:
    if opts.only in (None, "mlp"):
      mlp_split(res, opts.build)
    if opts.only in (None, "learner"):
      learner_split(res, dev, opts.build)
    if opts.only in (None, "categorical"):
      categorical_split(res, dev, opts.build)
    if opts.only in (None, "smz"):
      smz_split(res, dev, opts.build)
    if opts.only in (None, "sampler"):
      res["sampler"] = sampler_times(dev)
    if opts.only == "wide":
      wide_split(res, opts.build)
      wide_learner_split(res, dev, opts.build)
    if opts.only in ("wide", "wide_smz"):
      wide_smz_split(res, opts.build)
    if opts.only == "digests":
      parser.error("--only digests goes with --against")
  print(json.dumps(res))
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(res, f, indent=1)


# ---- the wide-tower instances (rows 1, 2 and 5a "wide") ------------------
#
# examples/run_2048.py's networks (A = 4, embedding 64, support 300,
# towers (256, 256): 492,278 search floats, 578,870 learner floats, past a
# block's shared memory), on the roots of native-pool boards after 24
# random legal moves under their legal masks (chip_smoke.py phase 30's
# inputs), at 64 and 1024 boards x 50 simulations, both policies; the
# learner at the example's batch 256, K = 5, on phase 30's windows.
WIDE_BOARDS = (64, 1024)

# Per-section stamps of the wide search: thread 0 of each block (or, in a
# copy of the global-weight instance of a checkout before the tile design,
# lane 0 of each warp) adds the cycles since its last stamp to its slot.
WIDE_PRE = r"""
__device__ unsigned long long g_wsec[16];
#define WSTAMP_INIT long long _last = clock64(); \
  unsigned long long _acc[16] = {};
#define WSTAMP(k) { long long _n = clock64(); _acc[k] += _n - _last; \
  _last = _n; }
#define WSTAMP_FLUSH(who) if (who) { \
  for (int _k = 0; _k < 16; ++_k) atomicAdd(&g_wsec[_k], _acc[_k]); }
"""
WIDE_POST = r"""
extern "C" int split_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_wsec);
  return cudaMemset(p, 0, sizeof(g_wsec));
}
extern "C" int split_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_wsec, sizeof(g_wsec));
}
"""
# The global-weight instance (fused_search_kernel<policy, G, false>, a warp
# an environment): the walk, the dynamics' hidden layers, the reward head
# and its decode, the next-state head and normaliser, the prediction's
# hidden layers, the value head and its decode, the policy head and its
# softmax, the install and backup; per warp.
WIDE_LDG_SECTIONS = ("walk", "dyn_hidden", "reward_head_decode",
                     "state_head_norm", "pred_hidden", "value_head_decode",
                     "policy_head_softmax", "install_backup")
WIDE_LDG_MARKS = [
    ('#include "group_mlp.cuh"\n', '#include "group_mlp.cuh"\n' + WIDE_PRE),
    ("  for (int sim = 0; sim < args.num_simulations; ++sim) {\n",
     "  WSTAMP_INIT\n"
     "  for (int sim = 0; sim < args.num_simulations; ++sim) {\n"),
    ("    // ---- descent ---", "    WSTAMP(7)\n    // ---- descent ---"),
    ("    // ---- expansion:", "    WSTAMP(0)\n    // ---- expansion:"),
    ("    float* ns = bufs[k];  // the reward logits",
     "    WSTAMP(1)\n    float* ns = bufs[k];  // the reward logits"),
    ("    p += in * S41 + S41;\n    float lo = INFINITY",
     "    p += in * S41 + S41;\n    WSTAMP(2)\n    float lo = INFINITY"),
    ("    p = towers + args.pred_offset;\n",
     "    WSTAMP(3)\n    p = towers + args.pred_offset;\n"),
    ("    const float value = decode_head<G, kLdg>(",
     "    WSTAMP(4)\n    const float value = decode_head<G, kLdg>("),
    ("    float* prior = t.cpri + slot * A;\n",
     "    WSTAMP(5)\n    float* prior = t.cpri + slot * A;\n"),
    ("    // ---- install (running mean)",
     "    WSTAMP(6)\n    // ---- install (running mean)"),
    ("    g.sync();\n  }\n\n  // ---- the root summary",
     "    g.sync();\n  }\n  WSTAMP(7)\n  WSTAMP_FLUSH((threadIdx.x & 31) == 0)"
     "\n\n  // ---- the root summary")]
# The tile kernel (fused_search_wide_kernel), per block (thread 0): the
# walk and its barrier; each phase (the product with its staging waits,
# the epilogue's stores into the cluster, the barrier), here the 2048
# net's two hidden layers and heads of each tower; the reward decode and
# the next state's normaliser; the value decode, install and backup.
WIDE_TILE_SECTIONS = ("walk", "dyn_hidden_0", "dyn_hidden_1", "dyn_heads",
                      "pred_hidden_0", "pred_hidden_1", "pred_heads",
                      "reward_decode_norm", "value_decode_install_backup")
WIDE_TILE_MARKS = [
    ('#include "group_mlp.cuh"\n', '#include "group_mlp.cuh"\n' + WIDE_PRE),
    ("  for (int sim = 0; sim < wa.num_simulations; ++sim) {\n",
     "  WSTAMP_INIT\n"
     "  for (int sim = 0; sim < wa.num_simulations; ++sim) {\n"),
    ("    // ---- walk: each env's descent",
     "    WSTAMP(8)\n    // ---- walk: each env's descent"),
    ("    // ---- dynamics: hidden layers, then both heads",
     "    WSTAMP(0)\n    // ---- dynamics: hidden layers, then both heads"),
    ("      cluster.sync();  // the dynamics' layer p is whole in every block\n",
     "      cluster.sync();  // the dynamics' layer p is whole in every block\n"
     "      WSTAMP(1 + p)\n"),
    ("    cluster.sync();  // the dynamics' heads are whole where they are "
     "read\n",
     "    cluster.sync();  // the dynamics' heads are whole where they are "
     "read\n    WSTAMP(1 + wa.n_dyn)\n"),
    ("    // ---- prediction: hidden layers, then the value and policy heads",
     "    WSTAMP(7)\n"
     "    // ---- prediction: hidden layers, then the value and policy heads"),
    ("      cluster.sync();  // the prediction's layer p is whole in every "
     "block\n",
     "      cluster.sync();  // the prediction's layer p is whole in every "
     "block\n      WSTAMP(1 + p)\n"),
    ("    cluster.sync();  // the prediction's heads are whole where they are "
     "read\n",
     "    cluster.sync();  // the prediction's heads are whole where they are "
     "read\n    WSTAMP(1 + p_heads)\n"),
    ("  // ---- the root summary of each env\n",
     "  WSTAMP(8)\n  WSTAMP_FLUSH(threadIdx.x == 0)\n"
     "  // ---- the root summary of each env\n")]


def wide_marks(src):
  """The wide search's stamps and section names for the source at hand:
  the tile kernel's (fused_search_wide_kernel), or the global-weight
  instance's in a checkout that still has it."""
  if "fused_search_wide_kernel" in src:
    return WIDE_TILE_MARKS, WIDE_TILE_SECTIONS
  return WIDE_LDG_MARKS, WIDE_LDG_SECTIONS


def _wide_stamped(src):
  for old, new in wide_marks(src)[0]:
    src = _one(src, old, new)
  return src + WIDE_POST


def wide_search_case(dev, B, policy):
  """(launch, net, inputs) of the wide search on B boards: chip_smoke.py
  phase 30's roots and masks."""
  import chip_smoke
  from muax_tpu_torch.examples import run_2048
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn
  _, _, net, _, _ = run_2048.setup(num_envs=1, device=dev)
  params = net.init_params((4, 4), torch.Generator().manual_seed(0))
  obs, legal = chip_smoke.host_boards(dev, B, chip_smoke.HOST_BOARD_MOVES)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  invalid = (1.0 - legal).contiguous()
  logits = torch.where(invalid > 0, -1e9, root.prior_logits).contiguous()
  weights = fused.extract_fused_weights(net, params)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          weights)
  kw = dict(num_simulations=chip_smoke.HOST_SIMS,
            support_size=net.support_size, discount=0.999,
            invalid_actions=invalid, max_depth=None)
  if policy == "gumbel":
    noise = gumbel_noise(torch.Generator(device=dev).manual_seed(0),
                         tuple(logits.shape), dev)
    kw["root_score"], kw["schedule"] = fused.gumbel_root_inputs(
        logits, noise, invalid, max_num_considered_actions=16,
        num_simulations=chip_smoke.HOST_SIMS)
  return lambda: fused._fused_search_cuda(*args, **kw)


def wide_split(res, build):
  """The wide search at 64 and 1024 boards, both policies: ms (CUDA
  events), then each section's cycles a simulation and share, from a
  stamped copy."""
  from muax_tpu_torch import _build
  cases = {f"wide_{p}_{B}": wide_search_case(torch.device("cuda", 0), B, p)
           for B in WIDE_BOARDS for p in ("muzero", "gumbel")}
  for key, fn in cases.items():
    res[key] = {"ms": events_ms(fn, 5)}
  print(json.dumps(res), flush=True)
  src = (pathlib.Path(_build.__file__).parent / "csrc"
         / "fused_search.cu").read_text()
  sections = wide_marks(src)[1]
  libs, _ = build_stamped(build, ["wide"])
  for key, fn in cases.items():
    buf = _stamped_run("fused_search_wide", "fused_search", fn, libs, 16)
    whole = sum(buf[:len(sections)])
    res[key]["section_share"] = {s: buf[k] / whole
                                 for k, s in enumerate(sections)}
    res[key]["section_cycles"] = {s: buf[k] for k, s in enumerate(sections)}


def wide_learner_case(dev):
  """(net, params, raw, coef, layout) of the wide learner: chip_smoke.py
  phase 30's windows of 256 boards, K = 5."""
  import chip_smoke
  from muax_tpu_torch.examples import run_2048
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.types import Transition
  _, _, net, _, _ = run_2048.setup(num_envs=1, device=dev)
  params = net.init_params((4, 4), torch.Generator().manual_seed(0))
  obs, _ = chip_smoke.host_boards(dev, chip_smoke.HOST_CHECK_ENVS,
                                  chip_smoke.HOST_BOARD_MOVES)
  B, K = chip_smoke.HOST_BATCH, chip_smoke.HOST_UNROLL
  gen = torch.Generator(device=dev).manual_seed(3)
  pick = torch.randint(0, obs.shape[0], (B, K), generator=gen, device=dev)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=dev)
  merges = torch.rand((B, K), generator=gen, device=dev) < 0.4
  batch = Transition(
      obs=obs.reshape(obs.shape[0], -1)[pick],
      action=torch.randint(0, 4, (B, K), generator=gen, device=dev),
      reward=torch.where(merges, 2.0 ** torch.randint(
          2, 9, (B, K), generator=gen, device=dev).float(), 0.0),
      done=torch.zeros((B, K), dtype=torch.bool, device=dev),
      rn=torch.rand((B, K), generator=gen, device=dev) * 400.0,
      value=torch.zeros((B, K), device=dev),
      pi=torch.softmax(torch.randn((B, K, 4), generator=gen, device=dev),
                       -1),
      weight=torch.rand((B,), generator=gen, device=dev) + 0.5,
      mask=(torch.arange(K, device=dev)[None] < lengths[:, None]).float())
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  return net, params, raw, coef, lay


# The wide learner's stamps: block stamps at its sections, as
# TILE_LEARNER_MARKS place them in the tile pass of a checkout whose wide
# learner is an instance of mlp_tile_kernel.
# The cluster pass (mlp_cluster_kernel): block stamps at its forward and
# backward, and each stage of products timed by thread 0 from its start
# (its copies and products) to its cluster barrier's end; the
# weight-gradient pass is a kernel of its own, timed by the profiler.
WIDE_LEARNER_SECTIONS = ("forward", "backward")
_CLUSTER_STAGE_START = ("                              const Out& o2, "
                        "float* sm) {\n  namespace cg = cooperative_groups;\n")
_CLUSTER_STAGE_END = ("hi - n1, sm);\n  cluster.sync();\n}\n")
_CLUSTER_END = ("  for (int l = l_rhead; l > 0; --l) bwd(l, 0, T);\n}\n\n"
                "// The linear table")
WIDE_LEARNER_MARKS = [
    (_CLUSTER_STAGE_START,
     _CLUSTER_STAGE_START + "  const long long _g0 = clock64();\n"),
    (_CLUSTER_STAGE_END, _CLUSTER_STAGE_END[:-2] + "  if (threadIdx.x == 0) "
     "g_gemm_cycles[blockIdx.x] += clock64() - _g0;\n}\n"),
    ("  // ---- cluster forward: the start observations",
     "  STAMP_INIT\n  // ---- cluster forward: the start observations"),
    ("  // ---- cluster backward: prediction over every step",
     "  STAMP(0)\n  // ---- cluster backward: prediction over every step"),
    (_CLUSTER_END, _CLUSTER_END.replace("T);\n}", "T);\n  STAMP(1)\n}"))]


def wide_learner_marks(src):
  """The wide learner's stamps and section names for the source at hand."""
  if "mlp_cluster_kernel" in src:
    return WIDE_LEARNER_MARKS, WIDE_LEARNER_SECTIONS
  return TILE_LEARNER_MARKS, TILE_LEARNER_SECTIONS


def _wide_learner_stamped(src):
  return _stamped(src, wide_learner_marks(src)[0], False)


def wide_learner_split(res, dev, build):
  """The wide learner at batch 256, K = 5: ms (CUDA events), each kernel's
  device ms (torch.profiler), its plan, then each section's share of the
  stamped kernel's block-cycles and the products' share within it."""
  from muax_tpu_torch import _build
  from muax_tpu_torch.device import device_limits
  from muax_tpu_torch.models import fused_learner
  net, params, raw, coef, lay = wide_learner_case(dev)
  lw = fused_learner.extract_learner_weights(net, params)

  def learn():
    return fused_learner._grad_cuda(lw, raw, coef, lay, l2_coef=1e-4,
                                    gradient_scale=0.5)

  plan = fused_learner.mlp_learner_plan(raw.shape[1], lay.K, lw,
                                        device_limits(dev))
  out = res["wide_learner"] = {"ms": events_ms(learn, 20),
                               "by_kernel_ms": by_kernel_ms(learn, 10),
                               "plan": plan._asdict()}
  print(json.dumps(res), flush=True)
  src = (pathlib.Path(_build.__file__).parent / "csrc"
         / "fused_learner.cu").read_text()
  sections = wide_learner_marks(src)[1]
  libs, _ = build_stamped(build, ["wide_learner"])
  buf = _stamped_run("fused_learner_wide", "fused_learner", learn, libs,
                     4096 * 8)
  tot = [sum(buf[b * 8 + k] for b in range(4096)) for k in range(8)]
  whole = sum(tot[:len(sections)])
  out["section_share"] = {s: tot[k] / whole for k, s in enumerate(sections)}
  out["product_share"] = {s: tot[4 + k] / whole
                          for k, s in enumerate(sections)}
  out["block_cycles"] = {s: tot[k] for k, s in enumerate(sections)}


# Every staged and categorical instance, in a checkout: a digest of its
# outputs on fixed inputs (the MLP search at 1024 envs with each G, both
# policies; the categorical search at 512 envs with clusters of 2 and 4,
# trees in shared memory and in the scratch, both policies; the MLP learner
# at batch 4096 and on the CartPole notebook's towers at K = 11, whose
# arena lies in the scratch; the categorical learner at batch 1024; the
# staged SMZ search on the fresh and deep-tree smz_mlp nets, and with its
# trees in the scratch at 800 simulations; the MLP search's wide mode at 64
# and 1024 boards, both policies; the sampler's two modes as phases 4 and
# 18 call them).
DIGEST_RUN = r"""
import copy, hashlib, json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
from muax_tpu_torch.models import fused_learner
from muax_tpu_torch.search import fused
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
def digest(ts):
  return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                 for t in ts)).hexdigest()[:16]
out = {}
mlp_plan, tiled_plan = fused.mlp_search_plan, fused.tiled_plan
for policy in ("muzero", "gumbel"):
  fn = ks.mlp_case(dev, 1024, policy)
  for group in fused.MLP_GROUPS:
    fused.mlp_search_plan = lambda *a, g=group, **kw: mlp_plan(
        *a, group=g, **kw)
    try:
      out[f"mlp_{policy}_G{group}"] = digest(fn())
    finally:
      fused.mlp_search_plan = mlp_plan
  fn = ks.search_case(dev, 512, policy)
  for cluster in (2, 4):
    for trees in (True, False):
      fused.tiled_plan = lambda *a, c=cluster, t=trees: tiled_plan(
          *a)._replace(cluster=c, smem_trees=t)
      try:
        out[f"categorical_{policy}_C{cluster}_smem_trees_{trees}"] = (
            digest(fn()))
      finally:
        fused.tiled_plan = tiled_plan
for name, kw in (("mlp_4096", dict(B=4096, family="mlp")),
                 ("mlp_notebook_K11", dict(B=1000, K=11, family="mlp",
                                           embedding_dim=10,
                                           repr_layers=(),
                                           layers=(64, 64, 16))),
                 ("categorical_1024", dict())):
  net, params, raw, coef, lay = ks.learner_case(dev, **kw)
  lw = fused_learner.extract_learner(net, params)
  out[f"learner_{name}"] = digest(fused_learner._grad_cuda(
      lw, raw, coef, lay, l2_coef=1e-4, gradient_scale=0.5))
fresh = ks.smz_network(dev).init_params((4,), torch.Generator().manual_seed(0))
deep = ks.deep_tree_params(copy.deepcopy(fresh))
for name, params, B, depth, sims in (
    ("fresh_256", fresh, 256, None, 200), ("fresh_64", fresh, 64, None, 200),
    ("deep_64_depth32", deep, 64, 32, 200),
    ("fresh_48_sims800", fresh, 48, None, 800)):  # trees in the scratch
  args, kw = ks.smz_inputs(dev, params, B, depth)
  kw["num_simulations"] = sims
  out[f"smz_{name}"] = digest(fused._fused_smz_search_cuda(
      *args, pb_c_init=1.25, pb_c_base=19652.0, **kw))
for policy in ("muzero", "gumbel"):
  for B in ks.WIDE_BOARDS:
    out[f"mlp_wide_{policy}_{B}"] = digest(ks.wide_search_case(dev, B,
                                                               policy)())
for name, (fn, _, _) in ks.sampler_cases(dev).items():
  out[f"sampler_{name}"] = digest(fn()[:1])
print("DIGESTS " + json.dumps(out))
""".replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))


# ---- the Stochastic MuZero search's wide-tower kernel (row 4 "wide") -----
#
# chip_smoke.py phase 33's launches: examples/run_2048.py's widths in
# make_stochastic_mlp_networks (A = 4, 32 chance outcomes, embedding 64,
# support 300, hidden (256, 256): 762,031 floats), on the roots of
# native-pool boards after 24 random legal moves under their legal masks,
# at 64 and 1024 boards x 200 simulations. Thread 0 of each block stamps
# the walk (with its cluster barrier), each part (its product with its
# ring waits, the epilogue's stores into the cluster, the barrier), the
# decodes after the decision and chance heads (with the next state's
# normaliser), and the prediction's decodes with the install and backup;
# and, summed over the parts, each part's product and its epilogue.
WIDE_SMZ_BOARDS = (64, 1024)
WIDE_SMZ_SECTIONS = ("walk", *(f"part_{p}" for p in range(12)),
                     "tower_decodes", "prediction_decodes_install_backup")
WIDE_SMZ_PART_PRE = r"""
__device__ unsigned long long g_wpart[2];  // products, epilogues
"""
WIDE_SMZ_PART_POST = r"""
extern "C" int split_part_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_wpart, sizeof(g_wpart));
}
extern "C" int split_part_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_wpart);
  return cudaMemset(p, 0, sizeof(g_wpart));
}
"""
WIDE_SMZ_MARKS = [
    ('#include "wide_tile.cuh"\n',
     '#include "wide_tile.cuh"\n' + WIDE_PRE + WIDE_SMZ_PART_PRE),
    # Thread 0's cycles in each part's product (its ring waits and the
    # split's partial sums included) and in its epilogue.
    ("  float acc[kT / 16][kNTW][4];\n  int ng, groups;\n"
     "  mz_wide::tile_product<kT, kNTW>(",
     "  float acc[kT / 16][kNTW][4];\n  int ng, groups;\n"
     "  const long long _p0 = clock64();\n"
     "  mz_wide::tile_product<kT, kNTW>("),
    ("      red, acc, &ng, &groups);\n\n  cg::cluster_group cluster",
     "      red, acc, &ng, &groups);\n  const long long _p1 = clock64();\n\n"
     "  cg::cluster_group cluster"),
    ("    }\n  }\n}\n\ntemplate <int kT, int kC, int kNTW>\n__global__",
     "    }\n  }\n  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&g_wpart[0], _p1 - _p0);\n"
     "    atomicAdd(&g_wpart[1], clock64() - _p1);\n  }\n}\n\n"
     "template <int kT, int kC, int kNTW>\n__global__"),
    ("  for (int sim = 0; sim < wa.num_simulations; ++sim) {\n"
     "    // ---- walk:",
     "  WSTAMP_INIT\n"
     "  for (int sim = 0; sim < wa.num_simulations; ++sim) {\n"
     "    // ---- walk:"),
    ("    cluster.sync();\n\n    // ---- the parts:",
     "    cluster.sync();\n    WSTAMP(0)\n\n    // ---- the parts:"),
    ("      cluster.sync();  // part p is whole where it is read\n",
     "      cluster.sync();  // part p is whole where it is read\n"
     "      WSTAMP(1 + (p < 12 ? p : 11))\n"),
    ("      __syncthreads();\n    }\n\n    // ---- the prediction's decodes",
     "      __syncthreads();\n      WSTAMP(13)\n    }\n\n"
     "    // ---- the prediction's decodes"),
    ("    __syncthreads();\n  }\n\n  // ---- the root summary of each env\n",
     "    __syncthreads();\n    WSTAMP(14)\n  }\n"
     "  WSTAMP_FLUSH(threadIdx.x == 0)\n\n"
     "  // ---- the root summary of each env\n")]


def _wide_smz_stamped(src):
  for old, new in WIDE_SMZ_MARKS:
    src = _one(src, old, new)
  return src + WIDE_POST + WIDE_SMZ_PART_POST


def wide_smz_case(dev, B, skip=0):
  """(launch, args, kwargs) of the wide SMZ search on B boards:
  chip_smoke.py phase 33's roots and masks (with ``skip``, the boards after
  the first ``skip`` of a pool of skip + B)."""
  import chip_smoke
  from muax_tpu_torch.models import make_stochastic_mlp_networks
  from muax_tpu_torch.search import fused
  net = make_stochastic_mlp_networks(4, device=dev, **chip_smoke.SMZ_WIDE_NET)
  params = net.init_params((4, 4), torch.Generator().manual_seed(
      chip_smoke.SEED))
  obs, legal = chip_smoke.host_boards(dev, skip + B,
                                      chip_smoke.HOST_BOARD_MOVES)
  gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
  args, kwargs = chip_smoke.wide_smz_launch(
      net, params, obs[skip:].contiguous(), legal[skip:].contiguous(), gen)
  return (lambda: fused._fused_smz_search_cuda(
      *args, pb_c_init=1.25, pb_c_base=19652.0, **kwargs)), args, kwargs


# --against's rounds of the wide SMZ search: each round runs both
# checkouts in the order other, this, this, other, a fresh process a run,
# at each point: (boards, boards skipped) of wide_smz_case, 64 boards also
# on two other sets of roots.
WIDE_SMZ_AB_POINTS = {"64": (64, 0), "64_skip64": (64, 64),
                      "64_skip128": (64, 128), "112": (112, 0),
                      "1024": (1024, 0)}
WIDE_SMZ_ROUNDS = 5
WIDE_SMZ_RUN = r"""
import json, sys, torch
sys.path[:0] = [".", TOOLS]
import kernel_split as ks
torch.backends.cuda.matmul.allow_tf32 = False
print("WIDE_SMZ " + json.dumps(ks.wide_smz_times(torch.device("cuda", 0))))
""".replace("TOOLS", repr(os.path.dirname(os.path.abspath(__file__))))


def wide_smz_times(dev, reps=5):
  """The wide SMZ search in a checkout (``--against``), at each of
  WIDE_SMZ_AB_POINTS: the kernel its plan takes, the ms a launch (CUDA
  events over ``reps`` launches) and a digest of the outputs."""
  import hashlib
  from muax_tpu_torch.search import fused
  out = {}
  for name, (B, skip) in WIDE_SMZ_AB_POINTS.items():
    fn, args, kwargs = wide_smz_case(dev, B, skip)
    plan = fused.smz_launch_plan(args[0], args[3], **kwargs)
    out[name] = {"plan": type(plan).__name__, **plan._asdict(),
              "ms": events_ms(fn, reps),
              "outputs_sha256": hashlib.sha256(b"".join(
                  t.cpu().numpy().tobytes() for t in fn())).hexdigest()[:16]}
  return out


def wide_smz_variants(plan, B, args, kwargs):
  """The tile kernel's plan and the other layouts of its instance that fit
  a block at B boards: the most parts resident beside two, four and eight
  ring slots, and none resident beside eight."""
  from muax_tpu_torch.device import device_limits
  from muax_tpu_torch.search import fused
  limit = device_limits(args[0].device).smem_per_block
  widths = fused._smz_widths(args[3])
  sims = kwargs["num_simulations"]

  def variant(k, ring):
    v = plan._replace(n_resident=k, ring=ring)
    lay = fused.smz_wide_plan_layout(v, 4, 32, 64, 601, sims, sims, *widths)
    if lay is None or lay.smem_bytes > limit:
      return None
    return v._replace(ring=ring if k < len(lay.parts) else 0,
                      smem_bytes=lay.smem_bytes)

  out = {"plan": plan}
  for ring in (2, 4, 8):
    k = next(k for k in range(27, -1, -1) if variant(k, ring) or k == 0)
    if variant(k, ring):
      out[f"resident_{k}_ring_{ring}"] = variant(k, ring)
  if variant(0, 8):
    out["resident_0_ring_8"] = variant(0, 8)
  return out


def wide_smz_split(res, build):
  """The wide SMZ search at 64 and 1024 boards: ms (CUDA events) of the
  search's own plan (the tile kernel's) and of each other layout of it
  that fits (``wide_smz_variants``), with a digest of the outputs; then
  each section's cycles a simulation and share of the plan, from a
  stamped copy."""
  import hashlib
  from muax_tpu_torch.search import fused
  dev = torch.device("cuda", 0)
  cases = {}
  chosen = fused.smz_launch_plan

  def forced(fn, plan):
    def run():
      fused.smz_launch_plan = lambda *a, **k: plan
      try:
        return fn()
      finally:
        fused.smz_launch_plan = chosen
    return run

  for B in WIDE_SMZ_BOARDS:
    fn, args, kwargs = wide_smz_case(dev, B)
    tile = chosen(args[0], args[3], **kwargs)
    cases[B] = forced(fn, tile)
    out = res[f"wide_smz_{B}"] = {"plan": tile._asdict(), "variants": {}}
    variants = wide_smz_variants(tile, B, args, kwargs)
    for name, variant in variants.items():
      run = forced(fn, variant)
      digest = hashlib.sha256(b"".join(
          t.cpu().numpy().tobytes() for t in run())).hexdigest()[:16]
      out["variants"][name] = {"ms": events_ms(run, 3),
                               "outputs_sha256": digest}
      print(json.dumps({f"wide_smz_{B}": {name: out["variants"][name]}}),
            flush=True)
    out["ms"] = out["variants"]["plan"]["ms"]
  libs, _ = build_stamped(build, ["wide_smz"])
  lib = libs["fused_smz_wide"]
  lib.split_part_read.argtypes = [ctypes.c_void_p]
  for B, fn in cases.items():
    lib.split_part_reset()
    buf = _stamped_run("fused_smz_wide", "fused_smz", fn, libs, 16)
    part = (ctypes.c_ulonglong * 2)()
    lib.split_part_read(ctypes.addressof(part))
    plan = res[f"wide_smz_{B}"]["plan"]
    blocks = -(-B // plan["tile"]) * plan["cluster"]
    per_sim = blocks * 200
    whole = sum(buf[:len(WIDE_SMZ_SECTIONS)])
    res[f"wide_smz_{B}"]["section_share"] = {
        s: buf[k] / whole for k, s in enumerate(WIDE_SMZ_SECTIONS) if buf[k]}
    res[f"wide_smz_{B}"]["cycles_a_sim"] = {
        s: buf[k] / per_sim for k, s in enumerate(WIDE_SMZ_SECTIONS)
        if buf[k]}
    # Of the parts' cycles: their products and their epilogues (the rest
    # is the cluster barriers).
    res[f"wide_smz_{B}"]["parts_cycles_a_sim"] = {
        "products": part[0] / per_sim, "epilogues": part[1] / per_sim}


def categorical_split(res, dev, build):
  """The categorical learner's and search's times, cluster sizes, section
  shares and the learner's accuracy."""
  from muax_tpu_torch.models import fused_learner
  net, params, raw, coef, lay = learner_case(dev)
  spec = fused_learner.extract_categorical_learner_spec(net, params)

  def learn():
    return fused_learner._grad_cuda(spec, raw, coef, lay, l2_coef=1e-4,
                                    gradient_scale=0.5)

  res["learner_ms"] = events_ms(learn, 20)
  res["learner_by_kernel_ms"] = by_kernel_ms(learn, 10)
  res["learner_accuracy"] = accuracy(net, params, raw, coef, lay)
  searches = {f"search_{p}_{B}": search_case(dev, B, p)
              for B in (2048, 512) for p in ("muzero", "gumbel")}
  from muax_tpu_torch.search import fused
  chosen = fused.tiled_plan
  for key, fn in searches.items():
    res[key] = {"ms": events_ms(fn, 5)}
    for blocks in (2, 4):  # each cluster size, for the record
      fused.tiled_plan = lambda *a, blocks=blocks: chosen(*a)._replace(
          cluster=blocks)
      try:
        res[key][f"ms_cluster_{blocks}"] = events_ms(fn, 5)
      finally:
        fused.tiled_plan = chosen
  print(json.dumps(res), flush=True)
  libs, names = build_stamped(build, ["categorical"])
  res["learner_sections"], res["learner_products"] = shares(
      "fused_learner", learn, libs, names)
  for key, fn in searches.items():
    res[key]["sections"], res[key]["products"] = shares(
        "fused_search", fn, libs, names)


if __name__ == "__main__":
  main()
