"""Root/recurrent inference closures bridging networks into the search
(``muax_tpu/train/inference.py``): integer h-support decode for the MLP
family, linear [vmin, vmax] two-hot decode for the acme families."""
from __future__ import annotations

import torch

from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.ops import logits_to_scalar, two_hot_logits_to_scalar
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput


def _value_head_decoder(networks):
  """Logits -> scalar for either head convention: integer h-transform
  support (``MZNetworks``) or linear [vmin, vmax] two-hot (the acme
  families, which carry ``num_bins``)."""
  if hasattr(networks, "num_bins"):
    return lambda logits: two_hot_logits_to_scalar(logits, networks.vmin,
                                                   networks.vmax)
  return lambda logits: logits_to_scalar(logits, networks.support_size)


def make_root_fn(networks: MZNetworks):
  """(params, obs [B, ...]) -> RootFnOutput"""
  decode = _value_head_decoder(networks)

  def root_fn(params: MZParams, obs: torch.Tensor) -> RootFnOutput:
    embedding = params.representation(obs)
    policy_logits, value_logits = params.prediction(embedding)
    value = decode(value_logits)
    return RootFnOutput(prior_logits=policy_logits, value=value,
                        embedding=embedding)

  return root_fn


def make_recurrent_fn(networks: MZNetworks, discount: float):
  """(params, generator, action [B], embedding) ->
  (RecurrentFnOutput, next_embedding): dyn -> pred on the next state."""
  decode = _value_head_decoder(networks)

  def recurrent_fn(params: MZParams, generator, action: torch.Tensor,
                   embedding: torch.Tensor):
    del generator
    reward_logits, next_embedding = params.dynamic(embedding, action)
    policy_logits, value_logits = params.prediction(next_embedding)
    reward = decode(reward_logits)
    value = decode(value_logits)
    output = RecurrentFnOutput(
        reward=reward,
        discount=torch.full_like(reward, discount),
        prior_logits=policy_logits,
        value=value,
    )
    return output, next_embedding

  return recurrent_fn
