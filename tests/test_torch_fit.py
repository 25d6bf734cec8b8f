"""The port's ``fit`` loop on the CPU: smoke runs as ``tests/test_e2e.py``
runs the JAX one (MuZero and Gumbel, through the fused search and through
the generic engine), a bit-exact resume as
``tests/test_checkpoint.py:84-115``,
the resume guards, the checkpoint round trip, the fused-status report,
reanalyze inside ``fit`` (bit-exact across a resume), Catch learned with the
name-keyed adam as ``tests/test_e2e.py:39-63`` learns it, and string env
ids resolved through the registry."""
import os

import numpy as np
import pytest
import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import AutoResetWrapper, CartPole
from muax_tpu_torch.fused_status import format_fused_status, fused_status
from muax_tpu_torch.models import (make_mlp_networks,
                                   make_stochastic_mlp_networks)
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.replay import replay_init
from muax_tpu_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                             save_pytree)
from muax_tpu_torch.train.fit import fit
from muax_tpu_torch.train.learner import TrainState


def _config(search=None, **train):
  kwargs = dict(num_envs=8, collect_steps=6, batch_size=8,
                updates_per_iteration=2, unroll_steps=2, n_bootstrap=3)
  kwargs.update(train)
  return MuZeroConfig(search=SearchConfig(num_simulations=4,
                                          **(search or {})),
                      replay=ReplayConfig(capacity=64, min_fill=8),
                      train=TrainConfig(**kwargs))


def _networks():
  return make_mlp_networks(num_actions=2, embedding_dim=4, support_size=5,
                           device="cpu")


def _fit(tmp, **kwargs):
  args = dict(eval_every=2, log_every=2, log_fn=lambda s: None, seed=11,
              model_dir=str(tmp))
  args.update(kwargs)
  config = args.pop("config", None) or _config()
  optimizer = args.pop("optimizer", None) or muzero_optimizer(warmup_steps=2)
  return fit(CartPole(), _networks(), config, optimizer, **args)


def test_cartpole_smoke(tmp_path):
  state, results = _fit(tmp_path, num_iterations=4)
  assert state.step == 8
  assert len(results["history"]) == 3  # iterations 1, 2 and 4
  assert results["model_path"] is not None
  assert os.path.exists(results["model_path"])
  assert np.isfinite(results["best_reward"])
  for row in results["history"]:
    for k, v in row.items():
      assert np.isfinite(v), (k, v)


@pytest.mark.parametrize("search", [dict(policy="gumbel"),
                                    dict(fused=False),
                                    dict(policy="gumbel", fused=False)])
def test_cartpole_smoke_other_searches(tmp_path, search):
  """``fit`` with Gumbel MuZero (the fused search's Gumbel mode) and with
  the generic engine (``search.fused=False``)."""
  state, results = _fit(tmp_path, num_iterations=2,
                        config=_config(search=search))
  assert state.step == 4
  assert results["model_path"] is not None
  for row in results["history"]:
    for k, v in row.items():
      assert np.isfinite(v), (k, v)


def test_resume_is_bit_exact(tmp_path):
  """Resuming the iteration-2 snapshot of a 4-iteration run reproduces the
  uninterrupted run bit for bit (parameters, optimizer state, history)."""
  _check_resume(tmp_path, _config())


def test_gumbel_resume_is_bit_exact(tmp_path):
  """The same with Gumbel MuZero, whose root noise comes from the
  checkpointed generator."""
  _check_resume(tmp_path, _config(search=dict(policy="gumbel")))


def _check_resume(tmp_path, config, **kwargs):
  state_a, results_a = _fit(tmp_path, num_iterations=4, checkpoint_every=2,
                            save_best=False, config=config, **kwargs)
  mid = os.path.join(str(tmp_path), "ckpt_it000002.pkl")
  assert load_checkpoint(
      os.path.join(str(tmp_path), "ckpt_latest.pkl"))["iteration"] == 4
  state_b, results_b = _fit(tmp_path / "resumed", num_iterations=4,
                            resume_from=mid, save_best=False, config=config,
                            **kwargs)
  for (name, a), b in zip(state_a.params.state_dict().items(),
                          state_b.params.state_dict().values()):
    assert torch.equal(a, b), name
  assert torch.equal(state_a.opt_state.mu, state_b.opt_state.mu)
  assert state_a.step == state_b.step
  drop = ("env_steps_per_s",)
  assert [{k: v for k, v in row.items() if k not in drop}
          for row in results_a["history"]] == [
              {k: v for k, v in row.items() if k not in drop}
              for row in results_b["history"]]


def test_resume_guards(tmp_path):
  _fit(tmp_path, num_iterations=1, checkpoint_every=1, save_best=False)
  latest = os.path.join(str(tmp_path), "ckpt_latest.pkl")
  with pytest.raises(ValueError, match="config hash"):
    _fit(tmp_path, num_iterations=2, resume_from=latest,
         config=_config(samples_per_insert=99.0))
  ckpt = load_checkpoint(latest)
  ckpt["train_state"].opt_state = ckpt["train_state"].opt_state._replace(
      mu=np.zeros(3, np.float32))
  bad = os.path.join(str(tmp_path), "bad.pkl")
  save_pytree(bad, {**ckpt, "generator": ckpt["generator"].numpy()})
  with pytest.raises(ValueError, match="optimizer"):
    _fit(tmp_path, num_iterations=2, resume_from=bad)


def test_spi_gate_limits_updates(tmp_path):
  # One warm-up iteration inserts 48 steps. Iteration 1: budget
  # 0.25 * 96 * 1.1 = 26.4 windows -> 3 updates of 8; iteration 2:
  # 0.25 * 144 * 1.1 = 39.6 -> 1 more.
  state, results = _fit(tmp_path, num_iterations=2, save_best=False,
                        config=_config(samples_per_insert=0.25,
                                       updates_per_iteration=4))
  assert state.step == 4


def test_checkpoint_roundtrip(tmp_path):
  net = _networks()
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  opt = muzero_optimizer()
  ts = TrainState(params, opt.init(params), step=7)
  rs = replay_init(16, 4, (4,), 2, device="cpu")
  env = AutoResetWrapper(CartPole())
  gen = torch.Generator().manual_seed(3)
  carry = env.reset(gen, 4)
  path = str(tmp_path / "full.pkl")
  save_checkpoint(path, train_state=ts, replay_state=rs, env_carry=carry,
                  generator=gen, iteration=12, counters={"best_reward": 1.5})
  ckpt = load_checkpoint(path, device="cpu")
  assert ckpt["iteration"] == 12 and ckpt["counters"]["best_reward"] == 1.5
  assert ckpt["train_state"].step == 7
  assert ckpt["replay_state"].capacity == 16
  torch.testing.assert_close(ckpt["env_carry"].obs, carry.obs)
  assert torch.equal(ckpt["generator"], gen.get_state())
  for name, value in params.state_dict().items():
    torch.testing.assert_close(ckpt["train_state"].params[name], value)


def test_fused_status_report():
  net = _networks()
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  rs = replay_init(16, 6, (4,), 2, device="cpu")
  assert format_fused_status(fused_status(net, _config(), params, rs)) == (
      "fused: search=on learner=on sampler=on")
  off = fused_status(net, _config(fused_sampler=False), params)
  assert off["fused_sampler"]["reason"].startswith("indeterminate")
  gumbel = fused_status(net, _config(search=dict(policy="gumbel")), params)
  assert gumbel["fused_search"] == {
      "active": True, "reason": "MLP triplet search kernel (gumbel mode)"}
  unfused = fused_status(net, _config(search=dict(fused=False)), params)
  assert unfused["fused_search"] == {
      "active": False, "reason": "disabled by config (search.fused)"}
  smz = make_stochastic_mlp_networks(2, num_chance_outcomes=4,
                                     embedding_dim=4, support_size=5,
                                     hidden=(8,), device="cpu")
  stochastic = fused_status(
      smz, _config(search=dict(policy="stochastic")),
      smz.init_params((4,), torch.Generator().manual_seed(0)), rs)
  assert stochastic["fused_search"] == {
      "active": True, "reason": "Stochastic MuZero forest search kernel"}
  assert stochastic["fused_sampler"] == {"active": True,
                                         "reason": "active (hybrid)"}
  assert not stochastic["fused_learner"]["active"]


def test_unported_parts_raise(tmp_path):
  # String env ids were refused until the host environments were ported;
  # "CartPole-v1" now resolves through the registry to the port's own
  # CartPole (the same run, bit for bit, as fit(CartPole(), ...)), and an
  # id that neither the registry nor gymnasium knows raises.
  _, by_name = fit("CartPole-v1", _networks(), _config(),
                   muzero_optimizer(warmup_steps=2), num_iterations=2,
                   eval_every=2, log_every=2, log_fn=lambda s: None,
                   seed=11, save_best=False)
  _, by_env = _fit(tmp_path, num_iterations=2, save_best=False)
  for a, b in zip(by_name["history"], by_env["history"], strict=True):
    a.pop("env_steps_per_s"), b.pop("env_steps_per_s")  # wall time
    assert a == b
  assert "test_G" in by_name["history"][-1]
  pytest.importorskip("gymnasium")
  with pytest.raises(Exception, match="NoSuchEnv"):
    fit("NoSuchEnv-v0", _networks(), _config(), num_iterations=1)


def test_reanalyze_resume_is_bit_exact(tmp_path):
  """``fit`` with reanalyze after every iteration: the refresh runs (its
  metrics are logged, the ring's target steps move) and a resume from the
  iteration-2 snapshot reproduces the run bit for bit: the draws come from
  the checkpointed generator and ``target_step`` is part of the ring."""
  _check_resume(tmp_path, _config(), reanalyze_every=1,
                reanalyze_segments=4)
  _, results = _fit(tmp_path / "again", num_iterations=2, save_best=False,
                    reanalyze_every=1, reanalyze_segments=4)
  row = results["history"][-1]
  assert row["reanalyzed_segments"] == 4.0
  assert np.isfinite(row["reanalyze_value_shift"])


def test_catch_learns_with_named_adam():
  """``tests/test_e2e.py:39-63`` on the port: 2-row Catch, whose catch
  reward is one step away, with ``create_optimizer("adam", lr=3e-3)``;
  random play averages about -1/3 and the greedy evaluation must pass 0.3
  within 50 iterations."""
  from muax_tpu_torch.envs import Catch
  from muax_tpu_torch.models.optimizers import create_optimizer
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=8, dirichlet_alpha=1.0),
      replay=ReplayConfig(capacity=256, min_fill=16),
      train=TrainConfig(num_envs=32, collect_steps=6, batch_size=64,
                        updates_per_iteration=16, unroll_steps=2,
                        n_bootstrap=3, discount=0.99,
                        temperature_schedule=((0.5, 1.0), (1.0, 0.5))))
  networks = make_mlp_networks(3, embedding_dim=16, support_size=3,
                               repr_layers=(32,), pred_layers=(32,),
                               dyn_layers=(32,), device="cpu")
  state, results = fit(Catch(rows=2, columns=3), networks, config,
                       create_optimizer("adam", lr=3e-3), num_iterations=50,
                       eval_every=10, log_every=10, save_best=False,
                       log_fn=lambda s: None, target_reward=0.9)
  assert results["best_reward"] >= -1.0
  test_gs = [row["test_G"] for row in results["history"] if "test_G" in row]
  assert max(test_gs) > 0.3, f"no learning progress: {test_gs}"
