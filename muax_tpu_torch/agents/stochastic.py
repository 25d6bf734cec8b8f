"""The standalone Stochastic MuZero agent (``muax_tpu/agents/stochastic.py``):
the five-network set, the decision/chance search of the generic engine's
stochastic policy, and autograd over the VQ-VAE unrolled loss."""
from __future__ import annotations

from typing import Optional

from muax_tpu_torch.agents.muzero import Agent
from muax_tpu_torch.config import SearchConfig
from muax_tpu_torch.models.optimizers import GradientTransformation
from muax_tpu_torch.models.stochastic_losses import stochastic_muzero_grad
from muax_tpu_torch.models.stochastic_networks import SMZNetworks
from muax_tpu_torch.search import stochastic_muzero_policy
from muax_tpu_torch.train.inference import make_smz_fns
from muax_tpu_torch.types import Transition


class StochasticMuZero(Agent):

  DEFAULT_SIMULATIONS = 200

  def __init__(
      self,
      networks: SMZNetworks,
      optimizer: Optional[GradientTransformation] = None,
      discount: float = 0.997,
      search_config: Optional[SearchConfig] = None,
      unroll_steps: int = 5,
      vqvae_beta: float = 0.25,
  ):
    search = search_config or SearchConfig(
        policy="stochastic", num_simulations=200,
        num_chance_outcomes=networks.num_chance_outcomes)
    super().__init__(networks, optimizer, discount, search, unroll_steps)
    self.vqvae_beta = vqvae_beta
    self._root_fn, self._decision_fn, self._chance_fn = make_smz_fns(
        networks, discount)

  def _plan(self, generator, obs, temperature, num_simulations):
    out = stochastic_muzero_policy(
        self.params, generator, self._root_fn(self.params, obs),
        decision_recurrent_fn=self._decision_fn,
        chance_recurrent_fn=self._chance_fn,
        num_simulations=num_simulations,
        num_chance_outcomes=self.networks.num_chance_outcomes,
        dirichlet_fraction=self.search.dirichlet_fraction,
        dirichlet_alpha=self.search.dirichlet_alpha,
        pb_c_init=self.search.pb_c_init, pb_c_base=self.search.pb_c_base,
        temperature=temperature, discount=self.discount)
    return out.action, out.action_weights, out.search_tree.summary().value

  def _grad(self, batch: Transition):
    return stochastic_muzero_grad(self.params, batch, self.networks,
                                  num_unroll_steps=self.unroll_steps,
                                  vqvae_beta=self.vqvae_beta)
