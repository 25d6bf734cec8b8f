"""The standalone Diffusion MuZero agent (``muax_tpu/agents/diffusion.py``):
plans with ``search.diffusion_policy.diffusion_muzero_policy`` over
flow-sampled next-state candidates and learns with autograd over
``models.diffusion_losses`` (flow matching inside the k-step unroll).
Same surface as the other agents: init / act / update / save / load."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from muax_tpu_torch.agents.muzero import Agent
from muax_tpu_torch.config import SearchConfig
from muax_tpu_torch.models.diffusion_losses import diffusion_muzero_grad
from muax_tpu_torch.models.diffusion_networks import DMZNetworks, DMZParams
from muax_tpu_torch.models.optimizers import GradientTransformation
from muax_tpu_torch.ops import logits_to_scalar
from muax_tpu_torch.search import (ChanceRecurrentFnOutput,
                                   DecisionRecurrentFnOutput, RootFnOutput)
from muax_tpu_torch.search.diffusion_policy import diffusion_muzero_policy
from muax_tpu_torch.types import Transition


class DiffusionMuZero(Agent):

  def __init__(
      self,
      networks: DMZNetworks,
      optimizer: Optional[GradientTransformation] = None,
      discount: float = 0.997,
      search_config: Optional[SearchConfig] = None,
      unroll_steps: int = 5,
      flow_coef: float = 1.0,
  ):
    search = search_config or SearchConfig(policy="stochastic",
                                           num_simulations=50)
    super().__init__(networks, optimizer, discount, search, unroll_steps)
    self.flow_coef = flow_coef

  # -- the search's closures -------------------------------------------------
  def _root_fn(self, params: DMZParams, obs):
    state = params.representation(obs)
    policy_logits, value_logits = params.prediction(state)
    return RootFnOutput(
        prior_logits=policy_logits,
        value=logits_to_scalar(value_logits, self.networks.support_size),
        embedding=state)

  def _decision_fn(self, params: DMZParams, generator, action, state):
    afterstate, av_logits = params.decision(state, action)
    # The candidates are exchangeable flow samples: a uniform chance prior.
    chance_logits = torch.zeros((state.shape[0], self.networks.num_samples),
                                dtype=state.dtype, device=state.device)
    return DecisionRecurrentFnOutput(
        chance_logits=chance_logits,
        afterstate_value=logits_to_scalar(
            av_logits, self.networks.support_size)), afterstate

  def _sample_fn(self, params: DMZParams, generator, afterstate):
    return self.networks.sample_candidates(params, generator, afterstate)

  def _chance_eval_fn(self, params: DMZParams, generator, next_state):
    policy_logits, value_logits = params.prediction(next_state)
    reward_logits = params.reward(next_state)
    support = self.networks.support_size
    return ChanceRecurrentFnOutput(
        action_logits=policy_logits,
        value=logits_to_scalar(value_logits, support),
        reward=logits_to_scalar(reward_logits, support))

  def _plan(self, generator, obs, temperature, num_simulations):
    out = diffusion_muzero_policy(
        self.params, generator, self._root_fn(self.params, obs),
        decision_recurrent_fn=self._decision_fn,
        sample_fn=self._sample_fn,
        chance_eval_fn=self._chance_eval_fn,
        num_simulations=num_simulations,
        num_samples=self.networks.num_samples,
        dirichlet_fraction=self.search.dirichlet_fraction,
        dirichlet_alpha=self.search.dirichlet_alpha,
        pb_c_init=self.search.pb_c_init, pb_c_base=self.search.pb_c_base,
        temperature=temperature, discount=self.discount)
    return out.action, out.action_weights, out.search_tree.summary().value

  # -- learning ---------------------------------------------------------------
  def _grad(self, batch: Transition, generator=None, draws=None):
    if generator is None and draws is None:
      # As the JAX agent's PRNGKey(0) on every call without a key.
      generator = torch.Generator(self.device).manual_seed(0)
    return diffusion_muzero_grad(self.params, batch, self.networks,
                                 generator, num_unroll_steps=self.unroll_steps,
                                 flow_coef=self.flow_coef, draws=draws)

  def update(self, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
             = None) -> float:
    """One gradient step; the flow-matching pairs come from ``generator``
    (a fresh one seeded with 0 when none is given, on every such call),
    or are injected through ``draws`` (``diffusion_muzero_loss``)."""
    return super().update(batch, generator=generator, draws=draws)
