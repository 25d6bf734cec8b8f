"""The premise of the MLP search kernel's compact tree, on the CPU.

The kernel (``csrc/fused_search.cu``, ``Tree``) keeps per node its visits,
value, reward and parent, and per edge only the child index and the prior:
it reads an edge's visits, value and reward through the child index. That
is exact only if, in the search the kernel is held to, every expanded
edge's visits, value and reward equal its child's, and every unexpanded edge
holds zeros. The plain version (``search/fused.py`` ``_plain_forest``) keeps
both copies, so its final trees can show it, for both policies and with a
depth cap that re-evaluates nodes in place. The root summaries read through
the child index must equal the plain version's outputs exactly.
"""
import numpy as np
import pytest
import torch

from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.inference import make_root_fn

SUPPORT, SIMS, BATCH, DISCOUNT = 5, 24, 16, 0.997


def _search(policy, num_actions, max_depth, with_invalid):
  rng = np.random.default_rng(3)
  net = make_mlp_networks(num_actions, embedding_dim=8, support_size=SUPPORT,
                          pred_layers=(8,), dyn_layers=(8,), device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  obs = torch.from_numpy(rng.normal(size=(BATCH, 4)).astype(np.float32))
  with torch.no_grad():
    root = make_root_fn(net)(params, obs * 5)
  invalid = None
  logits = root.prior_logits
  if with_invalid:
    pick = rng.integers(0, num_actions, size=BATCH)
    invalid = torch.from_numpy(np.eye(num_actions, dtype=np.float32)[pick])
    logits = torch.where(invalid > 0, -1e9, logits)
  kwargs = dict(num_simulations=SIMS, discount=DISCOUNT,
                invalid_actions=invalid, max_depth=max_depth)
  if policy == "gumbel":
    gumbel = torch.from_numpy(
        rng.gumbel(size=(BATCH, num_actions)).astype(np.float32))
    kwargs["root_score"], kwargs["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel, invalid, max_num_considered_actions=4,
        num_simulations=SIMS)
  spec = fused._as_spec(fused.extract_fused_weights(net, params), SUPPORT)
  args = (root.embedding, logits, root.value, spec)
  return (fused._plain_forest(*args, **kwargs),
          fused._plain_search(*args, **kwargs))


@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
@pytest.mark.parametrize("num_actions,max_depth,with_invalid", [
    (2, None, False),
    (3, 2, True),   # depth-capped: nodes at depth 2 are re-evaluated
])
def test_edges_copy_their_child(policy, num_actions, max_depth,
                                with_invalid):
  f, _ = _search(policy, num_actions, max_depth, with_invalid)
  rows = torch.arange(BATCH)[:, None, None]
  expanded = f.cidx >= 0
  child = f.cidx.clamp(min=0)
  assert int(expanded.sum()) > BATCH  # the trees did grow
  for edge, node in ((f.cvis, f.nvis), (f.cval, f.nval), (f.crew, f.nrew)):
    of_child = node[rows, child]
    assert torch.equal(edge[expanded], of_child[expanded])
    assert bool((edge[~expanded] == 0).all())
  # Each expanded edge is its child's only way in.
  n, a = torch.meshgrid(torch.arange(f.cidx.shape[1]),
                        torch.arange(f.cidx.shape[2]), indexing="ij")
  assert torch.equal(f.npar[rows, child][expanded],
                     n.expand_as(f.cidx)[expanded])
  assert torch.equal(f.nact[rows, child][expanded],
                     a.expand_as(f.cidx)[expanded])
  if max_depth is not None:  # fewer nodes than simulations: re-evaluated
    assert bool(((f.nvis[:, 1:] > 0).sum(-1) < SIMS).all())


@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
def test_root_summary_through_child_index(policy):
  f, (visits, value, q) = _search(policy, 3, 2, True)
  rows = torch.arange(BATCH)[:, None]
  kids = f.cidx[:, 0]
  child = kids.clamp(min=0)
  expanded = kids >= 0
  zero = torch.zeros_like(visits)
  assert torch.equal(torch.where(expanded, f.nvis[rows, child], zero),
                     visits)
  assert torch.equal(f.nval[:, 0], value)
  if policy == "muzero":
    compact_q = torch.where(
        expanded, f.nrew[rows, child] + DISCOUNT * f.nval[rows, child],
        zero)
    assert torch.equal(compact_q, q)
