"""AlphaZero-style self-play training: the search walks the real game, with
no learned dynamics (``muax_tpu/train/selfplay.py``).

The search "model" is the game itself: the tree's embeddings are batched
game states, an expansion steps the game, and the policy/value network
evaluates the leaves. The players alternate, so an edge's discount is -1
(the zero-sum transform); a terminal node's discount is 0, which ends its
subtree at the final reward. Self-play, replay and learning run over B
games at once on the networks' device, through the generic search engine
(``search/core.py``): the fused search kernels take the learned-dynamics
families only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from muax_tpu_torch.envs.base import Environment, _select
from muax_tpu_torch.models.az_networks import AZNetwork, AZParams
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              apply_updates)
from muax_tpu_torch.ops import segment_n_step_returns
from muax_tpu_torch.replay.buffer import (ReplayState, gumbel_noise,
                                          replay_sample,
                                          replay_update_priorities)
from muax_tpu_torch.search import muzero_policy
from muax_tpu_torch.search.action_selection import make_exploration_selection
from muax_tpu_torch.search.core import search as run_search
from muax_tpu_torch.search.policies import (_apply_temperature,
                                            _get_logits_from_probs)
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput
from muax_tpu_torch.types import Transition

_BIG_NEG = -1e9


def make_az_recurrent_fn(game: Environment, network: AZNetwork):
  """The search's dynamics is the real game: the player flips (discount
  -1), a terminal node keeps only its reward (discount 0, value 0), and
  illegal children get -1e9 logits."""

  def recurrent_fn(params: AZParams, generator, action, embedding):
    del generator
    new_state, obs, reward, done = game.step(embedding, action)
    policy_logits, value = network.apply(params, obs)
    legal = game.legal_actions(new_state)
    out = RecurrentFnOutput(
        reward=reward,
        discount=torch.where(done, 0.0, -1.0),
        prior_logits=torch.where(legal > 0, policy_logits, _BIG_NEG),
        value=torch.where(done, 0.0, value))
    return out, new_state

  return recurrent_fn


def make_az_policy_fn(game: Environment, network: AZNetwork,
                      num_simulations: int = 64,
                      dirichlet_fraction: float = 0.25,
                      dirichlet_alpha: float = 0.3,
                      max_depth: Optional[int] = None,
                      search_policy: Optional[str] = None):
  """(params, generator, batched game state, temperature) ->
  (action [B] int32, pi [B, A], root_value [B]).

  ``search_policy`` picks an in-tree selection rule of the zoo
  (puct/pucb/ucb/ltr/pltr/pnltr/bfs) at every depth; None keeps MuZero's
  PUCT over normalised Q values with Dirichlet noise at the root.
  """
  recurrent_fn = make_az_recurrent_fn(game, network)
  override = (make_exploration_selection(search_policy)
              if search_policy is not None else None)

  @torch.no_grad()
  def policy_fn(params: AZParams, generator: torch.Generator, state,
                temperature):
    legal = game.legal_actions(state)
    policy_logits, value = network.apply(params, game.observation(state))
    root = RootFnOutput(
        prior_logits=torch.where(legal > 0, policy_logits, _BIG_NEG),
        value=value, embedding=state)
    if override is not None:
      tree = run_search(
          params, generator, root=root, recurrent_fn=recurrent_fn,
          root_action_selection_fn=override,
          interior_action_selection_fn=override,
          num_simulations=num_simulations, max_depth=max_depth,
          invalid_actions=1.0 - legal)
      summary = tree.summary()
      logits = _apply_temperature(
          _get_logits_from_probs(summary.visit_probs), temperature)
      action = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=generator)[:, 0]
      return action.to(torch.int32), summary.visit_probs, summary.value
    out = muzero_policy(
        params, generator, root, recurrent_fn,
        num_simulations=num_simulations, invalid_actions=1.0 - legal,
        max_depth=max_depth, dirichlet_fraction=dirichlet_fraction,
        dirichlet_alpha=dirichlet_alpha, temperature=temperature)
    return out.action, out.action_weights, out.search_tree.summary().value

  return policy_fn


def az_loss(params: AZParams, batch: Transition, network: AZNetwork,
            l2_coef: float = 1e-4):
  """Policy cross-entropy toward the search's visits plus value MSE toward
  the game outcome, weighted per window, plus L2 over every network
  parameter. Returns (total, metrics with the priorities
  |value - z|^0.5 + 1e-6)."""
  obs = batch.obs[:, 0]
  pi_target = batch.pi[:, 0]
  z = batch.rn[:, 0]
  policy_logits, value = network.apply(params, obs)
  policy_loss = -torch.sum(pi_target * F.log_softmax(policy_logits, -1),
                           dim=-1)
  value_loss = torch.square(value - z)
  l2 = l2_coef * 0.5 * sum(torch.sum(torch.square(p))
                           for p in params.network.parameters())
  total = torch.mean(batch.weight * (policy_loss + value_loss)) + l2
  metrics = {
      "loss": total,
      "policy_loss": torch.mean(policy_loss),
      "value_loss": torch.mean(value_loss),
      "priorities": torch.abs(value - z).detach() ** 0.5 + 1e-6,
  }
  return total, metrics


class AZConfig(NamedTuple):
  num_simulations: int = 64
  num_envs: int = 128
  collect_steps: int = 18
  batch_size: int = 256
  updates_per_iteration: int = 4
  replay_capacity: int = 1024
  dirichlet_fraction: float = 0.25
  dirichlet_alpha: float = 0.3
  l2_coef: float = 1e-4


def make_az_selfplay_fn(game: Environment, network: AZNetwork,
                        config: AZConfig):
  """selfplay(params, state, generator, temperature) -> (state, segments
  [B, T, ...], priorities [B, T], metrics): T moves of B games, both sides
  played by the shared network; a finished game restarts in place. The
  outcome targets run backwards with the sign alternating,
  z_t = r_t - z_{t+1}, stopping at terminals and bootstrapping from the
  search value at the segment's cut."""
  policy_fn = make_az_policy_fn(game, network, config.num_simulations,
                                config.dirichlet_fraction,
                                config.dirichlet_alpha)

  @torch.no_grad()
  def selfplay(params: AZParams, state, generator: torch.Generator,
               temperature):
    steps = {k: [] for k in ("obs", "action", "reward", "done", "value",
                             "pi")}
    for _ in range(config.collect_steps):
      action, pi, root_value = policy_fn(params, generator, state,
                                         temperature)
      steps["obs"].append(game.observation(state))
      new_state, _, reward, done = game.step(state, action)
      fresh, _ = game.reset(generator, action.shape[0])
      state = _select(done, fresh, new_state)
      for k, v in (("action", action), ("reward", reward), ("done", done),
                   ("value", root_value), ("pi", pi)):
        steps[k].append(v)
    # [B, T, ...]
    seg = {k: torch.stack(v, dim=1) for k, v in steps.items()}
    z = segment_n_step_returns(
        seg["reward"].T, seg["value"].T, seg["done"].T.to(torch.float32),
        discount=-1.0, n=config.collect_steps).T
    priorities = torch.abs(seg["value"] - z) ** 0.5 + 1e-6
    B, T = seg["action"].shape
    segments = Transition(
        obs=seg["obs"], action=seg["action"], reward=seg["reward"],
        done=seg["done"], rn=z, value=seg["value"], pi=seg["pi"],
        weight=torch.ones((B,), device=z.device),
        mask=torch.ones((B, T), device=z.device))
    metrics = {"episodes_finished": torch.sum(seg["done"]),
               "mean_root_value": torch.mean(seg["value"])}
    return state, segments, priorities, metrics

  return selfplay


def make_az_update_fn(network: AZNetwork, optimizer: GradientTransformation,
                      config: AZConfig):
  """update(params, opt_state, replay_state, generator) -> (params,
  opt_state, replay_state, metrics): a batch of one-step windows drawn by
  priority, ``az_loss``'s gradient, one optimizer step over the flat
  parameters (in place), and the windows' priorities refreshed in
  place."""

  def update(params: AZParams, opt_state, replay_state: ReplayState,
             generator: torch.Generator):
    batch, seg_idx, starts = replay_sample(replay_state, generator,
                                           config.batch_size, 1)
    total, metrics = az_loss(params, batch, network, config.l2_coef)
    grads = torch.autograd.grad(total, list(params.parameters()))
    updates, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, updates)
    replay_update_priorities(replay_state, seg_idx, starts,
                             metrics.pop("priorities"))
    return params, opt_state, replay_state, {
        k: v.detach() for k, v in metrics.items()}

  return update


@torch.no_grad()
def evaluate_vs_random(game: Environment, network: AZNetwork,
                       params: AZParams, generator: torch.Generator,
                       num_games: int = 128,
                       num_simulations: int = 32) -> float:
  """Mean outcome (+1 win / 0 draw / -1 loss) of the greedy agent against a
  uniformly random legal player, the agent moving first in the even
  games. Stops once every game has ended."""
  policy_fn = make_az_policy_fn(game, network, num_simulations,
                                dirichlet_fraction=0.0)
  state, _ = game.reset(generator, num_games)
  device = state.to_play.device
  agent_is_first = torch.arange(num_games, device=device) % 2 == 0
  outcome = torch.zeros(num_games, device=device)
  finished = torch.zeros(num_games, dtype=torch.bool, device=device)
  for _ in range(game.spec.max_episode_steps):
    agents_turn = (state.to_play == 0) == agent_is_first
    a_agent, _, _ = policy_fn(params, generator, state, 0.0)
    legal = game.legal_actions(state)
    noise = gumbel_noise(generator, legal.shape, device)
    a_random = torch.argmax(torch.where(legal > 0, noise, -torch.inf), -1)
    action = torch.where(agents_turn, a_agent, a_random.to(torch.int32))
    state, _, reward, done = game.step(state, action)
    signed = torch.where(agents_turn, reward, -reward)
    outcome = torch.where(finished, outcome,
                          torch.where(done, signed, outcome))
    finished |= done
    if bool(finished.all()):
      break
  return float(torch.mean(outcome))
