"""Does a training run repeat its bits for one seed? Runs ``fit`` on
CartPole twice on the card, each run in a process of its own, with the same
seed and arguments, digests the state after every stage of every
iteration, and prints the first stage where the two runs differ.

  python3 tools/repro_fit.py [--config quickstart|parity]
      [--policy muzero|gumbel] [--iterations 20] [--seed 42]
      [--deterministic] [--out FILE]

``--config quickstart`` is ``muax_tpu_torch/examples/run_cartpole.py``'s
``setup``, ``parity`` the notebook config of
``muax_tpu_torch/examples/parity_cartpole.py``; ``fit`` runs
``--iterations`` iterations on the fused route with a log and an
evaluation cadence of that script, and no target. The stages, in the order
a run meets them: the rollout's segments and priorities and the env carry;
the ring after ``replay_add``; per learner group, the level-1 draws
(uniforms, online offsets), the Gumbel noise, the drawn segments and the
sampler's raw output (the sampled batch where the learner samples without
the sampler); per update, the learner's gradient and priorities, the
optimizer state and the parameters; the ring's priorities after the
refresh; the parameters and optimizer state after the iteration; the
evaluation's return. Then the final parameters, optimizer state, ring and
episodes of each iteration.

The tool wraps the port's functions from outside (module attributes of
``train.fit`` and ``train.learner``, the optimizer's ``update``) and
restores them afterwards. ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` in each run (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), a diagnostic: torch then names an op
it knows to be nondeterministic, or uses its deterministic version. Two
quickstart runs of 20 iterations take about a minute after the kernels'
build (about two minutes); from the root of a checkout:

  python3 tools/repro_fit.py --config parity --policy gumbel --out FILE

Prints one JSON line and exits 1 when the two runs differ.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(obj):
  """The tensors of ``obj`` (tensors, modules, dataclasses, sequences,
  dicts) in a fixed order, and its other leaves."""
  if isinstance(obj, torch.Tensor):
    yield obj
  elif isinstance(obj, torch.nn.Module):
    for name, t in sorted(obj.state_dict().items()):
      yield name
      yield t
  elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    for f in dataclasses.fields(obj):
      yield f.name
      yield from _tensors(getattr(obj, f.name))
  elif isinstance(obj, dict):
    for k in sorted(obj):
      yield k
      yield from _tensors(obj[k])
  elif isinstance(obj, (tuple, list)):
    for x in obj:
      yield from _tensors(x)
  else:
    yield repr(obj)


def digest(*objs) -> str:
  """The first 16 hex digits of a SHA-256 over the bytes, dtypes and shapes
  of every tensor of ``objs`` and the repr of their other leaves."""
  h = hashlib.sha256()
  for leaf in _tensors(objs):
    if isinstance(leaf, torch.Tensor):
      t = leaf.detach().contiguous().cpu().reshape(-1)
      h.update(f"{t.dtype}{tuple(leaf.shape)}".encode())
      h.update(t.view(torch.uint8).numpy().tobytes())
    else:
      h.update(str(leaf).encode())
  return h.hexdigest()[:16]


def ring_parts(rs) -> dict:
  return {f.name: digest(getattr(rs, f.name)) for f in dataclasses.fields(rs)}


@contextlib.contextmanager
def recording(records: list, optimizer):
  """Wraps ``train.fit``'s and ``train.learner``'s stages to append
  (rollout call, stage, digest) to ``records``; yields the wrapped
  optimizer and a dict that holds the ring once ``replay_add`` saw it."""
  from muax_tpu_torch.models.optimizers import GradientTransformation
  from muax_tpu_torch.train import fit as fit_mod
  from muax_tpu_torch.train import learner as learner_mod

  at = {"call": -1, "group": 0, "update": 0, "ring": None}

  def rec(stage, *objs):
    records.append([at["call"], stage, digest(*objs)])

  def where(name):
    return f"g{at['group']}.{name}"

  saved = {}

  def patch(module, name, make):
    saved[(module, name)] = getattr(module, name)
    setattr(module, name, make(getattr(module, name)))

  def on_rollout_fn(make):
    def make_rollout_fn(*a, **kw):
      rollout = make(*a, **kw)

      def wrapped(*ra, **rkw):
        at["call"] += 1
        carry, segments, prios, metrics = rollout(*ra, **rkw)
        rec("rollout.segments", segments)
        rec("rollout.priorities", prios)
        rec("rollout.env_carry", carry)
        return carry, segments, prios, metrics
      return wrapped
    return make_rollout_fn

  def on_replay_add(add):
    def replay_add(rs, *a, **kw):
      out = add(rs, *a, **kw)
      at["ring"] = out
      rec("replay_add.ring", out)
      return out
    return replay_add

  def on_multi_update_fn(make):
    def make_multi_update_fn(*a, **kw):
      multi_update = make(*a, **kw)

      def wrapped(*ma, **mkw):
        at["group"] = -1
        ts, rs, metrics = multi_update(*ma, **mkw)
        rec("update.params", ts.params)
        rec("update.opt_state", ts.opt_state)
        return ts, rs, metrics
      return wrapped
    return make_multi_update_fn

  def on_evaluate_fn(make):
    def make_evaluate_fn(*a, **kw):
      evaluate = make(*a, **kw)

      def wrapped(*ea, **ekw):
        out = evaluate(*ea, **ekw)
        rec("evaluate.return", out)
        return out
      return wrapped
    return make_evaluate_fn

  def on_draw_level1(fn):
    def draw_level1(*a, **kw):
      at["group"] += 1
      at["update"] = 0
      uniforms, offsets = fn(*a, **kw)
      rec(where("uniforms"), uniforms)
      rec(where("offsets"), offsets)
      return uniforms, offsets
    return draw_level1

  def after(name, count_group=False):
    def make(fn):
      def wrapped(*a, **kw):
        if count_group:
          at["group"] += 1
          at["update"] = 0
        out = fn(*a, **kw)
        rec(where(name), out)
        return out
      return wrapped
    return make

  def on_grad(fn):
    def wrapped(*a, **kw):
      grads, metrics = fn(*a, **kw)
      rec(where(f"u{at['update']}.grads"), grads)
      rec(where(f"u{at['update']}.learner_priorities"), metrics.priorities)
      return grads, metrics
    return wrapped

  def on_apply(fn):
    def apply_updates(params, updates):
      fn(params, updates)
      rec(where(f"u{at['update']}.params"), params)
      at["update"] += 1
    return apply_updates

  def on_refresh(fn):
    def replay_update_priorities(rs, *a, **kw):
      out = fn(rs, *a, **kw)
      rec(where("refresh.priorities"), rs.step_priorities)
      return out
    return replay_update_priorities

  def update(grads, opt_state, params):
    updates, new_state = optimizer.update(grads, opt_state, params)
    rec(where(f"u{at['update']}.opt_state"), new_state)
    return updates, new_state

  patch(fit_mod, "make_rollout_fn", on_rollout_fn)
  patch(fit_mod, "replay_add", on_replay_add)
  patch(fit_mod, "make_multi_update_fn", on_multi_update_fn)
  patch(fit_mod, "make_evaluate_fn", on_evaluate_fn)
  patch(learner_mod, "draw_level1", on_draw_level1)
  patch(learner_mod, "gumbel_noise", after("gumbel"))
  patch(learner_mod, "segments_from_draws", after("segments"))
  patch(learner_mod, "fused_sample_group", after("sampler_raw"))
  patch(learner_mod, "replay_sample", after("replay_sample", True))
  for name in ("fused_muzero_grad_raw", "fused_muzero_grad", "muzero_grad"):
    patch(learner_mod, name, on_grad)
  patch(learner_mod, "apply_updates", on_apply)
  patch(learner_mod, "replay_update_priorities", on_refresh)
  try:
    yield GradientTransformation(optimizer.init, update), at
  finally:
    for (module, name), fn in saved.items():
      setattr(module, name, fn)


def run_digests(config="quickstart", policy="muzero", device="cuda",
                seed=42, iterations=20) -> dict:
  """One ``fit`` run's digests: ``records`` (rollout call, stage, digest)
  after every stage, and ``final``: the parameters, the optimizer state,
  the ring (whole and by field), the episodes finished in each iteration
  (warm-up first) and the greedy returns."""
  from muax_tpu_torch.examples.parity_cartpole import make_run
  from muax_tpu_torch.train.fit import fit

  env, networks, cfg, optimizer, eval_every = make_run(policy, "fused",
                                                       device, config)
  records = []
  with tempfile.TemporaryDirectory() as model_dir, \
      recording(records, optimizer) as (optimizer, at):
    ts, results = fit(env, networks, cfg, optimizer,
                      num_iterations=iterations, seed=seed,
                      eval_every=eval_every, log_every=1,
                      model_dir=model_dir, save_best=False,
                      log_fn=lambda m: None)
  rs = at["ring"]
  episodes = [int(results["warmup_episodes"])] + [
      int(row["episodes_finished"]) for row in results["history"]]
  final = {"params": digest(ts.params), "opt_state": digest(ts.opt_state),
           "ring": digest(rs), **{f"ring.{k}": v
                                  for k, v in ring_parts(rs).items()},
           "episodes": episodes,
           "test_G": [row["test_G"] for row in results["history"]
                      if "test_G" in row]}
  warm = max(1, cfg.replay.min_fill // cfg.train.num_envs)
  return {"records": records, "final": final, "warmup_iterations": warm}


def first_difference(a: dict, b: dict):
  """The first record where runs ``a`` and ``b`` differ, or None; the
  iteration is fit's (warm-up iterations count 0 and below)."""
  warm = a["warmup_iterations"]
  for ra, rb in zip(a["records"], b["records"]):
    if ra != rb:
      return {"iteration": ra[0] - warm + 1, "stage": ra[1],
              "other_stage": rb[1], "digests": [ra[2], rb[2]]}
  if len(a["records"]) != len(b["records"]):
    return {"records": [len(a["records"]), len(b["records"])]}
  return None


def compare(runs: list) -> dict:
  """Every run against the first: the first differing stage, the final
  parts that differ."""
  out = {"identical": True, "records": len(runs[0]["records"]),
         "final": runs[0]["final"], "against_first": []}
  for other in runs[1:]:
    diff = first_difference(runs[0], other)
    parts = sorted(k for k in runs[0]["final"]
                   if runs[0]["final"][k] != other["final"].get(k))
    out["against_first"].append({"first_difference": diff,
                                 "final_parts_differing": parts})
    out["identical"] &= diff is None and not parts
  return out


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--config", choices=("quickstart", "parity"),
                 default="quickstart")
  p.add_argument("--policy", choices=("muzero", "gumbel"), default="muzero")
  p.add_argument("--iterations", type=int, default=20)
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--deterministic", action="store_true")
  p.add_argument("--out", default=None)
  p.add_argument("--child", default=None, help=argparse.SUPPRESS)
  args = p.parse_args()
  sys.path.insert(0, ROOT)
  if args.child:
    if args.deterministic:
      torch.use_deterministic_algorithms(True)
    out = run_digests(args.config, args.policy, "cuda", args.seed,
                      args.iterations)
    with open(args.child, "w") as f:
      json.dump(out, f)
    return
  if not torch.cuda.is_available():
    sys.exit("repro_fit: needs a CUDA card")
  env = dict(os.environ)
  if args.deterministic:
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
  runs = []
  with tempfile.TemporaryDirectory() as d:
    for i in range(2):
      path = os.path.join(d, f"run{i}.json")
      cmd = [sys.executable, os.path.abspath(__file__), "--child", path,
             "--config", args.config, "--policy", args.policy,
             "--iterations", str(args.iterations), "--seed", str(args.seed)]
      if args.deterministic:
        cmd.append("--deterministic")
      proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                            text=True)
      if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-8000:], file=sys.stderr)
        sys.exit(f"repro_fit: run {i} failed")
      with open(path) as f:
        runs.append(json.load(f))
  result = {"config": args.config, "policy": args.policy,
            "seed": args.seed, "iterations": args.iterations,
            "deterministic_mode": args.deterministic, **compare(runs)}
  print(json.dumps(result), flush=True)
  if args.out:
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
      json.dump({**result, "runs": runs}, f)
  sys.exit(0 if result["identical"] else 1)


if __name__ == "__main__":
  main()
