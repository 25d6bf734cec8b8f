"""Which fused kernels a setup takes, and why not (``muax_tpu/fused_status.py``).

One report over the port's three kernels: the search (in its MuZero or
Gumbel mode), the learner and the sampler. The learner and sampler entries reuse the learner's own dispatch
(``make_multi_update_fn``'s ``fused_group_status``), so the report cannot
drift from what the learner does. ``fit`` logs it once.

  >>> report = fused_status(networks, config, params, replay_state)
  >>> format_fused_status(report)
  'fused: search=on learner=on sampler=on'
"""
from __future__ import annotations

from typing import Any, Optional

from muax_tpu_torch.models.fused_learner import extract_learner_weights
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.train.learner import TrainState, make_multi_update_fn


def _search_status(config) -> dict:
  search = config.search
  if search.policy not in ("muzero", "gumbel"):
    return {"active": False,
            "reason": f"policy {search.policy!r} is not ported yet"}
  if not search.fused:
    return {"active": False, "reason": "disabled by config (search.fused)"}
  return {"active": True,
          "reason": f"MLP triplet search kernel ({search.policy} mode)"}


def fused_status(networks, config, params,
                 replay_state: Optional[Any] = None,
                 optimizer: Optional[Any] = None) -> dict:
  """Report {fused_search, fused_learner, fused_sampler}: each
  {"active": bool, "reason": str}. On the card an active entry launches its
  CUDA kernel; on the CPU it runs the kernel's plain version.

  ``replay_state`` is needed for the sampler entry (its gate reads the
  segment length); without it the entry says so.
  """
  if not config.train.fused_learner:
    learner = {"active": False, "reason": "disabled by config (fused_learner)"}
  elif extract_learner_weights(networks, params) is None:
    learner = {"active": False,
               "reason": "network family has no learner kernel (the "
                         "categorical LearnerSpec, ROADMAP.md A.3)"}
  else:
    learner = {"active": True, "reason": "loss+backward kernel"}
  report = {"fused_search": _search_status(config), "fused_learner": learner}
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
