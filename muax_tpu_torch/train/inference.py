"""Root/recurrent inference closures bridging networks into the search
(``muax_tpu/train/inference.py``, integer h-support decode)."""
from __future__ import annotations

import torch

from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.ops import logits_to_scalar
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput


def make_root_fn(networks: MZNetworks):
  """(params, obs [B, ...]) -> RootFnOutput"""

  def root_fn(params: MZParams, obs: torch.Tensor) -> RootFnOutput:
    embedding = params.representation(obs)
    policy_logits, value_logits = params.prediction(embedding)
    value = logits_to_scalar(value_logits, networks.support_size)
    return RootFnOutput(prior_logits=policy_logits, value=value,
                        embedding=embedding)

  return root_fn


def make_recurrent_fn(networks: MZNetworks, discount: float):
  """(params, generator, action [B], embedding) ->
  (RecurrentFnOutput, next_embedding): dyn -> pred on the next state."""

  def recurrent_fn(params: MZParams, generator, action: torch.Tensor,
                   embedding: torch.Tensor):
    del generator
    reward_logits, next_embedding = params.dynamic(embedding, action)
    policy_logits, value_logits = params.prediction(next_embedding)
    reward = logits_to_scalar(reward_logits, networks.support_size)
    value = logits_to_scalar(value_logits, networks.support_size)
    output = RecurrentFnOutput(
        reward=reward,
        discount=torch.full_like(reward, discount),
        prior_logits=policy_logits,
        value=value,
    )
    return output, next_embedding

  return recurrent_fn
