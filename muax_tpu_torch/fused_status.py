"""Which fused kernels a setup takes, and why not (``muax_tpu/fused_status.py``).

One report over the port's three kernels: the search (in its MuZero or
Gumbel mode, for the MLP triplet or the acme categorical family), the
learner and the sampler. The search entry reuses the actor's dispatch
(``uses_fused_search``), the learner and sampler entries the learner's own
(``make_multi_update_fn``'s ``fused_group_status``), so the report cannot
drift from what the learner does. ``fit`` logs it once.

  >>> report = fused_status(networks, config, params, replay_state)
  >>> format_fused_status(report)
  'fused: search=on learner=on sampler=on'
"""
from __future__ import annotations

from typing import Any, Optional

from muax_tpu_torch.models.fused_learner import (LearnerSpec,
                                                 extract_learner)
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.train.actor import uses_fused_search
from muax_tpu_torch.train.learner import TrainState, make_multi_update_fn


def _search_status(networks, config) -> dict:
  search = config.search
  if search.policy not in ("muzero", "gumbel"):
    return {"active": False,
            "reason": f"policy {search.policy!r} is not ported yet"}
  if not search.fused:
    return {"active": False, "reason": "disabled by config (search.fused)"}
  if not uses_fused_search(networks, config):
    return {"active": False,
            "reason": "network family has no search kernel (the fc-resnet "
                      "runs the generic engine)"}
  kind = "acme categorical" if hasattr(networks, "num_bins") else "MLP triplet"
  return {"active": True,
          "reason": f"{kind} search kernel ({search.policy} mode)"}


def fused_status(networks, config, params,
                 replay_state: Optional[Any] = None,
                 optimizer: Optional[Any] = None) -> dict:
  """Report {fused_search, fused_learner, fused_sampler}: each
  {"active": bool, "reason": str}. On the card an active entry launches its
  CUDA kernel; on the CPU it runs the kernel's plain version.

  ``replay_state`` is needed for the sampler entry (its gate reads the
  segment length); without it the entry says so.
  """
  lw = extract_learner(networks, params) if config.train.fused_learner else None
  if not config.train.fused_learner:
    learner = {"active": False, "reason": "disabled by config (fused_learner)"}
  elif lw is None:
    learner = {"active": False,
               "reason": "network family has no learner kernel (the "
                         "fc-resnet takes autograd over muzero_loss)"}
  else:
    learner = {"active": True, "reason": "loss+backward kernel" + (
        " (categorical LearnerSpec)" if isinstance(lw, LearnerSpec) else "")}
  report = {"fused_search": _search_status(networks, config),
            "fused_learner": learner}
  if replay_state is None:
    report["fused_sampler"] = {
        "active": False,
        "reason": "indeterminate: pass replay_state to evaluate the ring"}
  else:
    mu = make_multi_update_fn(networks, optimizer or muzero_optimizer(),
                              config)
    ts = TrainState(params=params, opt_state=None, step=0)
    mode, _, reason = mu.fused_group_status(ts, replay_state)
    report["fused_sampler"] = {"active": mode is not None, "reason": reason}
  return report


def format_fused_status(report: dict) -> str:
  """One log line: 'fused: search=on learner=on sampler=OFF(<why>)'."""
  parts = []
  for key in ("fused_search", "fused_learner", "fused_sampler"):
    name = key.split("_", 1)[1]
    entry = report[key]
    parts.append(f"{name}=on" if entry["active"]
                 else f"{name}=OFF({entry['reason']})")
  return "fused: " + " ".join(parts)
