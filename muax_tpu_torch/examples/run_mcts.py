"""MCTS over a simulator or a learned transition model, on the port.

``examples/run_mcts.py`` with its flags, defaults and configuration: B
games of Catch (5 x 5) play in parallel; the search (the generic engine,
no kernel) walks either the real env (``--simulator``, the default) or an
MLP transition model trained online from its own ring
(``--nosimulator``: ``model_replay_add``, then ``make_model_update_fn``'s
20 steps of 256 transitions with adam at 3e-3); the policy/value tower
(128, 128) learns from the search's visits and the n-step returns with
adam at 1e-3. From the root of a checkout:

  python -m muax_tpu_torch.examples.run_mcts --simulator
  python -m muax_tpu_torch.examples.run_mcts --nosimulator

``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs import AutoResetWrapper, Catch
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models.az_networks import make_az_mlp
from muax_tpu_torch.models.env_model import (
    ModelSearchParams, make_mlp_transition_model, make_model_policy_fn,
    make_model_update_fn, make_simulator_policy_fn, model_replay_add,
    model_replay_init)
from muax_tpu_torch.models.optimizers import (adam, apply_updates,
                                              flatten_optimizer)
from muax_tpu_torch.ops import segment_n_step_returns


def setup(simulator: bool = True, num_simulations: int = 32,
          rows: int = 5, device="cuda"):
  """The example's env, policy/value network and its optimizer, the policy
  function, and for the learned model (``simulator`` False) the model, its
  optimizer, ring and update function, else Nones
  (``examples/run_mcts.py:49-87``); a dict."""
  env = Catch(rows=rows, columns=5)
  network = make_az_mlp(env.spec.num_actions, hidden=(128, 128),
                        device=device)
  out = dict(env=env, network=network,
             net_opt=flatten_optimizer(adam(1e-3)), model=None,
             model_opt=None, model_replay=None, model_update=None)
  if simulator:
    out["policy_fn"] = make_simulator_policy_fn(
        env, network, num_simulations=num_simulations, discount=1.0)
    return out
  model = make_mlp_transition_model(env.spec.num_actions,
                                    env.spec.observation_shape,
                                    hidden=(128, 128), device=device)
  model_opt = flatten_optimizer(adam(3e-3))
  out.update(
      model=model, model_opt=model_opt,
      model_replay=model_replay_init(4096, env.spec.observation_shape,
                                     device=device),
      model_update=make_model_update_fn(model, model_opt, batch_size=256,
                                        num_sgd_steps=20),
      policy_fn=make_model_policy_fn(model, network,
                                     num_simulations=num_simulations,
                                     discount=1.0, terminal_tol=0.1))
  return out


@torch.no_grad()
def collect(policy_fn, wrapped, simulator: bool, net_params, model_params,
            carry, generator, steps: int):
  """``steps`` of search-act -> env.step over every game: (carry, a dict of
  [T, B, ...] tensors: obs, action, reward, done, next_obs, pi, value)."""
  out = {k: [] for k in ("obs", "action", "reward", "done", "next_obs",
                         "pi", "value")}
  for _ in range(steps):
    if simulator:
      action, pi, root_value = policy_fn(net_params, generator,
                                         carry.env_state, carry.obs, 1.0)
    else:
      action, pi, root_value = policy_fn(
          ModelSearchParams(network=net_params, model=model_params),
          generator, carry.obs, 1.0)
    new_carry, reward, done, _ = wrapped.step(carry, action, generator)
    for k, v in (("obs", carry.obs), ("action", action), ("reward", reward),
                 ("done", done), ("next_obs", new_carry.obs), ("pi", pi),
                 ("value", root_value)):
      out[k].append(v)
    carry = new_carry
  return carry, {k: torch.stack(v) for k, v in out.items()}


def net_loss(network, net_params, steps, n: int) -> torch.Tensor:
  """Policy cross-entropy toward the search's visits plus value MSE toward
  the n-step returns (``examples/run_mcts.py:103-120``, the AZLearner
  recipe of acme/tf/mcts/learning.py:29-120, vectorized)."""
  z = segment_n_step_returns(steps["reward"], steps["value"],
                             steps["done"].to(torch.float32), discount=1.0,
                             n=n)
  obs = steps["obs"].reshape((-1,) + tuple(steps["obs"].shape[2:]))
  pi = steps["pi"].reshape(-1, steps["pi"].shape[-1])
  logits, value = network.apply(net_params, obs)
  policy_loss = -torch.mean(torch.sum(
      pi.detach() * F.log_softmax(logits, -1), -1))
  value_loss = torch.mean(torch.square(value - z.reshape(-1).detach()))
  return policy_loss + value_loss


def net_update(network, net_opt, net_params, net_opt_state, steps, n: int):
  """One step of ``net_loss``'s gradient (the parameters stepped in place):
  (params, opt_state, loss)."""
  loss = net_loss(network, net_params, steps, n)
  grads = torch.autograd.grad(loss, list(net_params.parameters()))
  updates, net_opt_state = net_opt.update(grads, net_opt_state, net_params)
  apply_updates(net_params, updates)
  return net_params, net_opt_state, loss.detach()


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  the last iteration's (loss, catch rate, model metrics or None)."""
  p = flags.parser(__doc__)
  flags.add_bool(p, "simulator", True,
                 "search the real env (True) or a learned model (False)")
  p.add_argument("--iterations", type=int, default=60)
  p.add_argument("--num_envs", type=int, default=64)
  p.add_argument("--collect_steps", type=int, default=10)
  p.add_argument("--num_simulations", type=int, default=32)
  p.add_argument("--rows", type=int, default=5)
  p.add_argument("--seed", type=int, default=0)
  opts = p.parse_args(argv)
  device = resolve_device(opts.device)
  s = setup(opts.simulator, opts.num_simulations, opts.rows, device)
  env, network = s["env"], s["network"]
  wrapped = AutoResetWrapper(env)
  gen = torch.Generator(device=device).manual_seed(opts.seed)
  net_params = network.init_params(env.spec.observation_shape,
                                   torch.Generator().manual_seed(opts.seed))
  net_opt_state = s["net_opt"].init(net_params)
  carry = wrapped.reset(gen, opts.num_envs)
  model_params = model_opt_state = m_metrics = None
  if not opts.simulator:
    model_params = s["model"].init_params(
        torch.Generator().manual_seed(opts.seed + 1))
    model_opt_state = s["model_opt"].init(model_params)

  t0 = time.time()
  for it in range(opts.iterations):
    carry, steps = collect(s["policy_fn"], wrapped, opts.simulator,
                           net_params, model_params, carry, gen,
                           opts.collect_steps)
    if not opts.simulator:
      flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
              for k, v in steps.items()}
      model_replay_add(s["model_replay"], flat["obs"], flat["action"],
                       flat["reward"], flat["next_obs"], flat["done"])
      model_params, model_opt_state, m_metrics = s["model_update"](
          model_params, model_opt_state, s["model_replay"], gen)
    net_params, net_opt_state, loss = net_update(
        network, s["net_opt"], net_params, net_opt_state, steps,
        opts.collect_steps)
    caught = float(torch.sum(steps["reward"] > 0))
    missed = float(torch.sum(steps["reward"] < 0))
    rate = caught / max(caught + missed, 1.0)
    if (it + 1) % 10 == 0:
      extra = ""
      if not opts.simulator:
        extra = f" model_loss={float(m_metrics['model_loss']):.4f}"
      print(f"[{time.time()-t0:5.0f}s] it {it+1}: loss={float(loss):.3f} "
            f"catch_rate={rate:.2f}{extra}", flush=True)

  print(f"done ({'simulator' if opts.simulator else 'learned model'})")
  return float(loss), rate, m_metrics


if __name__ == "__main__":
  main()
