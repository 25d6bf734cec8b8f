"""Where the time of the categorical family's kernels goes, on one CUDA card.

Run from the root of a checkout (its ``muax_tpu_torch`` package and
``csrc/`` are the ones measured):

  python3 tools/kernel_split.py [--out FILE]

It times the categorical learner at batch 1024 (``categorical_training``'s
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

Last it sets the learner's priorities and gradients against the plain
version in float64: the largest error of the kernel and of the plain
version in float32, each relative to the float64 result. The stamps are
placed by the sources' section comments and lines, which an edit to those
lines must keep.
"""
import argparse
import copy
import ctypes
import json
import os
import pathlib
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
    ("  // ---- backward: prediction over every step",
     "  STAMP(0)\n  // backward"),
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


def build_stamped(build):
  """Stamped copies of the learner and search sources, built with nvcc;
  returns (libraries, section names) by source."""
  from muax_tpu_torch import _build
  csrc = pathlib.Path(_build.__file__).parent / "csrc"
  out = pathlib.Path(build)
  out.mkdir(parents=True, exist_ok=True)
  for header in csrc.glob("*.cuh"):
    shutil.copy(header, out / header.name)
  names, procs = {}, {}
  for name, marks, names[name], gemm in (
      ("fused_learner", LEARNER_MARKS, LEARNER_SECTIONS, True),
      ("fused_search", SEARCH_MARKS, SEARCH_SECTIONS, False)):
    src = (csrc / f"{name}.cu").read_text()
    (out / f"{name}.cu").write_text(_stamped(src, marks, gemm))
    procs[name] = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(out / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
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


def shares(name, fn, libs, names):
  """Each section's share of the stamped kernel's block-cycles, and the
  products' share within it (both of the whole)."""
  from muax_tpu_torch import _build
  plain = _build.load(name)
  _build._loaded[name] = libs[name]
  try:
    libs[name].split_reset()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (4096 * 8))()
    libs[name].split_read(ctypes.addressof(buf))
  finally:
    _build._loaded[name] = plain
  tot = [sum(buf[b * 8 + k] for b in range(4096)) for k in range(8)]
  n = len(names[name])
  whole = sum(tot[:n])
  return ({s: tot[k] / whole for k, s in enumerate(names[name])},
          {s: tot[4 + k] / whole for k, s in enumerate(names[name])})


def learner_case(dev, B=1024, A=2, K=5):
  from muax_tpu_torch.models import (fused_learner,
                                     make_categorical_mlp_networks)
  from muax_tpu_torch.types import Transition
  net = make_categorical_mlp_networks(A, device=dev, **BENCH)
  params = net.init_params((4,), torch.Generator().manual_seed(1))
  gen = torch.Generator(device=dev).manual_seed(0)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=dev)
  batch = Transition(
      obs=torch.randn((B, K, 4), generator=gen, device=dev),
      action=torch.randint(0, A, (B, K), generator=gen, device=dev),
      reward=torch.randn((B, K), generator=gen, device=dev) * 3,
      done=torch.zeros((B, K), dtype=torch.bool, device=dev),
      rn=torch.randn((B, K), generator=gen, device=dev) * 40,
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
  spec = fused_learner.extract_categorical_learner_spec(net, params)
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, spec, **kw)
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


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=None, help="also write the JSON here")
  parser.add_argument("--build", default="build/split",
                      help="directory for the stamped copies")
  opts = parser.parse_args()
  sys.path.insert(0, os.getcwd())  # the checkout measured is the cwd's
  if not torch.cuda.is_available():
    sys.exit("kernel_split: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  from muax_tpu_torch.models import fused_learner
  dev = torch.device("cuda", 0)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  res = {"card": card}
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
  libs, names = build_stamped(opts.build)
  res["learner_sections"], res["learner_products"] = shares(
      "fused_learner", learn, libs, names)
  for key, fn in searches.items():
    res[key]["sections"], res[key]["products"] = shares(
        "fused_search", fn, libs, names)
  print(json.dumps(res))
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(res, f, indent=1)


if __name__ == "__main__":
  main()
