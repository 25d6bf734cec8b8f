"""The port's generic search engine (``search/{tree,qtransforms,
action_selection,core,policies}.py``) against the JAX package's, on the CPU.

- The three qtransforms and every selection rule on one seeded tree, built
  with the same numbers on both sides: rtol 1e-6 (float32 arithmetic in the
  same order); the actions exactly, with JAX's tie-break noise injected into
  the rules that add it.
- ``muzero_policy`` with the JAX networks' weights: at most 2 visits apart,
  root value rtol = atol = 1e-3 (``tests/test_fused.py:56-60``): its random
  tie-break differs between the two.
- ``gumbel_muzero_policy`` with JAX's own Gumbel draw injected: visits and
  actions exactly (deterministic given the noise,
  ``tests/test_fused.py:175-202``). Rewards and values in the tree are
  decoded scalars, atol 5e-4 / rtol 1e-4 as in
  ``tests/test_torch_networks.py`` (the network runs in each framework's
  own matmul, so its logits agree to 1e-6, and the expectation over 41 bins
  and h^-1 amplify that); the weights softmax(logits + sigma(q-hat)) carry
  the same error, since sigma scales the min-max normalised q by
  0.1 (50 + max visits), so they get atol 5e-4 / rtol 1e-4 too. The fused
  plain version, whose network arithmetic is the kernel's, is held to the
  tighter rtol 1e-4 / atol 1e-5 in ``tests/test_torch_fused_gumbel.py``.
- The behavioural bandit cases of ``tests/test_search.py`` and
  ``tests/test_selection_zoo.py``, run on the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.search import action_selection as jsel
from muax_tpu.search import gumbel_muzero_policy as j_gumbel_policy
from muax_tpu.search import muzero_policy as j_muzero_policy
from muax_tpu.search import qtransforms as jqt
from muax_tpu.search import seq_halving as jseq
from muax_tpu.search.policies import GumbelExtraData as JExtra
from muax_tpu.search.tree import Tree as JTree
from muax_tpu.search.types import RootFnOutput as JRoot
from muax_tpu.train.inference import make_recurrent_fn as j_recurrent
from muax_tpu_torch.search import action_selection as sel
from muax_tpu_torch.search import qtransforms as qt
from muax_tpu_torch.search import seq_halving
from muax_tpu_torch.search.core import search
from muax_tpu_torch.search.policies import (GumbelExtraData,
                                            gumbel_muzero_policy,
                                            muzero_policy)
from muax_tpu_torch.search.tree import ROOT_INDEX, Tree
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput
from muax_tpu_torch.train.inference import make_recurrent_fn

from test_torch_fused_search import EMBED, _nets, _roots

B, N, A = 16, 9, 4


def _tree_numpy(seed):
  """A seeded tree's node and edge statistics (no structure is needed by
  the qtransforms and selection rules)."""
  rng = np.random.default_rng(seed)
  children_visits = rng.integers(0, 3, (B, N, A)).astype(np.int32)
  invalid = np.zeros((B, A), np.float32)
  invalid[::3, 2] = 1.0
  return dict(
      node_visits=rng.integers(1, 12, (B, N)).astype(np.int32),
      node_values=rng.standard_normal((B, N)).astype(np.float32),
      node_raw_values=rng.standard_normal((B, N)).astype(np.float32),
      parents=np.full((B, N), -1, np.int32),
      action_from_parent=np.full((B, N), -1, np.int32),
      children_index=np.full((B, N, A), -1, np.int32),
      children_prior_logits=rng.standard_normal((B, N, A)).astype(np.float32),
      children_visits=children_visits,
      children_rewards=rng.standard_normal((B, N, A)).astype(np.float32),
      children_discounts=rng.uniform(0.9, 1.0, (B, N, A)).astype(np.float32),
      children_values=rng.standard_normal((B, N, A)).astype(np.float32),
      embeddings=np.zeros((B, N, 1), np.float32),
      root_invalid_actions=invalid,
      gumbel=rng.gumbel(size=(B, A)).astype(np.float32),
      node_index=rng.integers(0, N, B).astype(np.int32))


def _trees(seed):
  arrays = _tree_numpy(seed)
  gumbel, node_index = arrays.pop("gumbel"), arrays.pop("node_index")
  j_tree = JTree(**{k: jnp.asarray(v) for k, v in arrays.items()},
                 extra_data=JExtra(root_gumbel=jnp.asarray(gumbel)))
  t = {k: torch.from_numpy(v) for k, v in arrays.items()}
  for name in ("parents", "action_from_parent", "children_index"):
    t[name] = t[name].long()
  tree = Tree(**t, extra_data=GumbelExtraData(
      root_gumbel=torch.from_numpy(gumbel)))
  return j_tree, tree, jnp.asarray(node_index), torch.from_numpy(
      node_index).long()


QTRANSFORMS = {
    "parent_and_siblings": (jqt.qtransform_by_parent_and_siblings,
                            qt.qtransform_by_parent_and_siblings),
    "min_max": (functools.partial(jqt.qtransform_by_min_max, min_value=-3.0,
                                  max_value=3.0),
                functools.partial(qt.qtransform_by_min_max, min_value=-3.0,
                                  max_value=3.0)),
    "mix_value": (jqt.qtransform_completed_by_mix_value,
                  qt.qtransform_completed_by_mix_value),
    "raw_value": (functools.partial(jqt.qtransform_completed_by_mix_value,
                                    use_mixed_value=False),
                  functools.partial(qt.qtransform_completed_by_mix_value,
                                    use_mixed_value=False)),
}


@pytest.mark.parametrize("name", sorted(QTRANSFORMS))
def test_qtransforms_match_jax(name):
  j_fn, fn = QTRANSFORMS[name]
  j_tree, tree, j_idx, idx = _trees(0)
  np.testing.assert_allclose(fn(tree, idx).numpy(),
                             np.asarray(j_fn(j_tree, j_idx)), rtol=1e-6,
                             atol=1e-6)


def _rules():
  table = jseq.considered_visit_table(4, 12)
  rules = {
      "muzero": (jsel.make_muzero_action_selection(),
                 sel.make_muzero_action_selection()),
      "gumbel_root": (
          functools.partial(jsel.gumbel_muzero_root_action_selection,
                            table=jnp.asarray(table),
                            max_num_considered_actions=4),
          functools.partial(sel.gumbel_muzero_root_action_selection,
                            table=torch.from_numpy(table),
                            max_num_considered_actions=4)),
      "gumbel_interior": (jsel.gumbel_muzero_interior_action_selection,
                          sel.gumbel_muzero_interior_action_selection),
  }
  for kind in ("puct", "pucb", "ucb", "ltr", "pltr", "pnltr", "bfs"):
    rules[kind] = (jsel.make_exploration_selection(kind),
                   sel.make_exploration_selection(kind))
  return rules


@pytest.mark.parametrize("name", sorted(_rules()))
@pytest.mark.parametrize("depth,sim", [(0, 0), (0, 5), (1, 9)])
def test_selection_rules_match_jax(name, depth, sim, monkeypatch):
  """The rules that add 1e-7 tie-break noise get JAX's own uniform draw
  (equal visit counts tie exactly, as in BFS and among unvisited children),
  so every rule is compared exactly."""
  j_fn, fn = _rules()[name]
  j_tree, tree, j_idx, idx = _trees(1)
  if depth == 0:
    j_idx, idx = jnp.zeros_like(j_idx), torch.zeros_like(idx)
  key = jax.random.PRNGKey(0)
  monkeypatch.setattr(sel, "_tie_noise", lambda generator, like: (
      torch.from_numpy(np.array(jax.random.uniform(key, like.shape)))
      * 1e-7))
  ref = j_fn(key, j_tree, j_idx, jnp.asarray(depth), jnp.asarray(sim))
  got = fn(torch.Generator().manual_seed(0), tree, idx, depth, sim)
  np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
  if depth == 0 and name != "gumbel_interior":  # only the root rules mask
    assert not bool(tree.root_invalid_actions[torch.arange(B), got].any())


def test_unknown_selection_kind_raises():
  with pytest.raises(ValueError, match="unknown selection kind"):
    sel.make_exploration_selection("nope")


# ---------------------------------------------------------------------------
# Policies over the MLP triplet against JAX.
# ---------------------------------------------------------------------------


def _policy_setup(seed, num_actions, with_invalid):
  j_net, j_params, net, params = _nets(num_actions, (16,))
  emb, logits, value, invalid = _roots(seed, 16, num_actions, with_invalid)
  j_root = JRoot(prior_logits=jnp.asarray(logits), value=jnp.asarray(value),
                 embedding=jnp.asarray(emb))
  root = RootFnOutput(prior_logits=torch.from_numpy(logits),
                      value=torch.from_numpy(value),
                      embedding=torch.from_numpy(emb))
  j_inv = None if invalid is None else jnp.asarray(invalid)
  inv = None if invalid is None else torch.from_numpy(invalid)
  return (j_net, j_params, j_root, j_inv), (net, params, root, inv)


@pytest.mark.parametrize("with_invalid,max_depth", [(False, None),
                                                    (True, 2)])
def test_muzero_policy_matches_jax(with_invalid, max_depth):
  (j_net, j_params, j_root, j_inv), (net, params, root, inv) = (
      _policy_setup(2, 3, with_invalid))
  kwargs = dict(num_simulations=20, max_depth=max_depth,
                dirichlet_fraction=0.0)
  ref = j_muzero_policy(j_params, jax.random.PRNGKey(3), j_root,
                        j_recurrent(j_net, 0.97), invalid_actions=j_inv,
                        **kwargs)
  out = muzero_policy(params, torch.Generator().manual_seed(3), root,
                      make_recurrent_fn(net, 0.97), invalid_actions=inv,
                      **kwargs)
  visits = out.search_tree.summary().visit_counts.numpy()
  ref_summary = ref.search_tree.summary()
  np.testing.assert_array_equal(visits.sum(-1), 20.0)
  assert np.abs(visits - np.asarray(ref_summary.visit_counts)).max() <= 2
  np.testing.assert_allclose(out.search_tree.summary().value.numpy(),
                             np.asarray(ref_summary.value), rtol=1e-3,
                             atol=1e-3)
  assert out.action.dtype == torch.int32
  if inv is not None:
    assert float(out.action_weights[inv > 0].max()) == 0.0


@pytest.mark.parametrize("with_invalid,max_depth,m", [(False, None, 16),
                                                      (True, 2, 4)])
def test_gumbel_policy_matches_jax(with_invalid, max_depth, m):
  (j_net, j_params, j_root, j_inv), (net, params, root, inv) = (
      _policy_setup(4, 4, with_invalid))
  rng = jax.random.PRNGKey(6)
  _, gumbel_rng, _ = jax.random.split(rng, 3)
  gumbel = jax.random.gumbel(gumbel_rng, (16, 4), jnp.float32)
  kwargs = dict(num_simulations=24, max_depth=max_depth,
                max_num_considered_actions=m)
  ref = j_gumbel_policy(j_params, rng, j_root, j_recurrent(j_net, 0.97),
                        invalid_actions=j_inv, **kwargs)
  out = gumbel_muzero_policy(params, torch.Generator().manual_seed(6), root,
                             make_recurrent_fn(net, 0.97),
                             invalid_actions=inv,
                             gumbel=torch.from_numpy(np.array(gumbel)),
                             **kwargs)
  ref_summary = ref.search_tree.summary()
  summary = out.search_tree.summary()
  np.testing.assert_array_equal(summary.visit_counts.numpy(),
                                np.asarray(ref_summary.visit_counts))
  np.testing.assert_array_equal(out.action.numpy(), np.asarray(ref.action))
  np.testing.assert_allclose(out.action_weights.numpy(),
                             np.asarray(ref.action_weights), rtol=1e-4,
                             atol=5e-4)
  np.testing.assert_allclose(summary.value.numpy(),
                             np.asarray(ref_summary.value), rtol=1e-3,
                             atol=1e-3)


def test_search_tree_structure_matches_jax():
  """Every field of the generic Gumbel search's tree, node for node."""
  (j_net, j_params, j_root, _), (net, params, root, _) = (
      _policy_setup(8, 2, False))
  rng = jax.random.PRNGKey(1)
  _, gumbel_rng, _ = jax.random.split(rng, 3)
  gumbel = jax.random.gumbel(gumbel_rng, (16, 2), jnp.float32)
  ref = j_gumbel_policy(j_params, rng, j_root, j_recurrent(j_net, 0.97),
                        num_simulations=10).search_tree
  tree = gumbel_muzero_policy(params, torch.Generator(), root,
                              make_recurrent_fn(net, 0.97),
                              num_simulations=10,
                              gumbel=torch.from_numpy(np.array(gumbel))
                              ).search_tree
  for name in ("node_visits", "parents", "action_from_parent",
               "children_index", "children_visits"):
    np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                  np.asarray(getattr(ref, name)), name)
  for name in ("node_values", "node_raw_values", "children_rewards",
               "children_discounts", "children_values",
               "children_prior_logits", "embeddings"):
    np.testing.assert_allclose(getattr(tree, name).numpy(),
                               np.asarray(getattr(ref, name)), rtol=1e-4,
                               atol=5e-4, err_msg=name)
  assert tree.node_visits.dtype == torch.int32
  assert tree.embeddings.shape == (16, 11, EMBED)


# ---------------------------------------------------------------------------
# Bandits (tests/test_search.py, tests/test_selection_zoo.py) on the port.
# ---------------------------------------------------------------------------


def bandit_recurrent_fn(rewards, discount=0.0):
  """Deterministic bandit: reward depends only on the action."""
  rewards = torch.tensor(rewards, dtype=torch.float32)
  num_actions = rewards.shape[0]

  def fn(params, generator, action, embedding):
    del params, generator
    batch = action.shape[0]
    out = RecurrentFnOutput(
        reward=rewards[action],
        discount=torch.full((batch,), discount),
        prior_logits=torch.zeros((batch, num_actions)),
        value=torch.zeros((batch,)))
    return out, embedding

  return fn


def uniform_root(batch, num_actions, value=0.0):
  return RootFnOutput(prior_logits=torch.zeros((batch, num_actions)),
                      value=torch.full((batch,), value),
                      embedding=torch.zeros((batch, 1)))


def _gen(seed=0):
  return torch.Generator().manual_seed(seed)


def test_muzero_finds_best_arm():
  out = muzero_policy((), _gen(), uniform_root(4, 4),
                      bandit_recurrent_fn([0.0, 1.0, 0.2, 0.5]),
                      num_simulations=64, dirichlet_fraction=0.0,
                      temperature=0.0)
  np.testing.assert_array_equal(out.action.numpy(), 1)
  assert bool((out.action_weights[:, 1] > 0.4).all())


def test_tree_invariants():
  sims = 32
  tree = muzero_policy((), _gen(1), uniform_root(2, 3),
                       bandit_recurrent_fn([0.1, 0.2, 0.3], discount=0.9),
                       num_simulations=sims).search_tree
  np.testing.assert_array_equal(tree.node_visits[:, ROOT_INDEX].numpy(),
                                sims + 1)
  np.testing.assert_array_equal(
      tree.children_visits[:, ROOT_INDEX].sum(-1).numpy(), sims)
  for b in range(2):
    for node in range(1, sims + 1):
      if int(tree.node_visits[b, node]) == 0:
        continue
      parent = int(tree.parents[b, node])
      action = int(tree.action_from_parent[b, node])
      assert int(tree.children_index[b, parent, action]) == node


def test_root_value_is_mean_backup():
  tree = muzero_policy((), _gen(2), uniform_root(1, 2),
                       bandit_recurrent_fn([0.0, 1.0]), num_simulations=50,
                       dirichlet_fraction=0.0).search_tree
  visits = tree.children_visits[0, ROOT_INDEX].double().numpy()
  expected = np.sum(visits * np.array([0.0, 1.0])) / (np.sum(visits) + 1.0)
  np.testing.assert_allclose(float(tree.node_values[0, ROOT_INDEX]),
                             expected, rtol=1e-5)


def test_invalid_actions_never_selected():
  invalid = torch.tensor([[0.0, 1.0, 0.0, 1.0]] * 3)
  out = muzero_policy((), _gen(3), uniform_root(3, 4),
                      bandit_recurrent_fn([0.0, 10.0, 0.1, 10.0]),
                      num_simulations=40, invalid_actions=invalid)
  root_visits = out.search_tree.children_visits[:, ROOT_INDEX]
  assert int(root_visits[:, [1, 3]].max()) == 0
  assert float(out.action_weights[:, [1, 3]].max()) == 0.0
  assert bool(torch.isin(out.action, torch.tensor([0, 2],
                                                  dtype=torch.int32)).all())


def test_max_depth():
  def fn(params, generator, action, embedding):
    batch = action.shape[0]
    return RecurrentFnOutput(reward=torch.zeros(batch),
                             discount=torch.ones(batch),
                             prior_logits=torch.zeros((batch, 2)),
                             value=torch.zeros(batch)), embedding

  tree = muzero_policy((), _gen(4), uniform_root(1, 2), fn,
                       num_simulations=10, max_depth=1).search_tree
  # Only the two root children are ever expanded (then re-evaluated).
  assert int((tree.node_visits[0] > 0).sum()) <= 3


def test_two_player_sign_flip():
  """A negative discount alternates players: a move worth +1 to the
  opponent one ply down scores badly at the root."""
  def fn(params, generator, action, embedding):
    batch = action.shape[0]
    return RecurrentFnOutput(
        reward=torch.zeros(batch), discount=torch.full((batch,), -1.0),
        prior_logits=torch.zeros((batch, 2)),
        value=(action == 0).float()), embedding

  out = muzero_policy((), _gen(5), uniform_root(2, 2), fn,
                      num_simulations=30, dirichlet_fraction=0.0,
                      temperature=0.0)
  np.testing.assert_array_equal(out.action.numpy(), 1)


def test_gumbel_finds_best_arm():
  out = gumbel_muzero_policy((), _gen(0), uniform_root(8, 4),
                             bandit_recurrent_fn([0.0, 0.1, 1.0, 0.2]),
                             num_simulations=32)
  np.testing.assert_array_equal(out.action.numpy(), 2)


def test_gumbel_weights_are_improved_policy():
  out = gumbel_muzero_policy((), _gen(1), uniform_root(4, 3),
                             bandit_recurrent_fn([0.0, 1.0, 0.5]),
                             num_simulations=24)
  w = out.action_weights
  torch.testing.assert_close(w.sum(-1), torch.ones(4))
  assert bool((w[:, 1] > w[:, 0]).all() and (w[:, 1] > w[:, 2]).all())


def test_gumbel_respects_invalid_actions():
  invalid = torch.tensor([[0.0, 1.0, 0.0]] * 4)
  out = gumbel_muzero_policy((), _gen(2), uniform_root(4, 3),
                             bandit_recurrent_fn([0.2, 5.0, 0.6]),
                             num_simulations=16, invalid_actions=invalid)
  assert bool((out.action != 1).all())
  assert int(out.search_tree.children_visits[:, ROOT_INDEX, 1].max()) == 0


def test_gumbel_few_simulations():
  out = gumbel_muzero_policy((), _gen(3), uniform_root(2, 8),
                             bandit_recurrent_fn([0.0] * 7 + [1.0]),
                             num_simulations=4)
  assert out.action.shape == (2,)
  np.testing.assert_array_equal(
      out.search_tree.children_visits[:, ROOT_INDEX].sum(-1).numpy(), 4)


def test_batch_elements_independent():
  """Each element's best arm is stored in its embedding."""
  def fn(params, generator, action, embedding):
    batch = action.shape[0]
    best = embedding[:, 0].long()
    return RecurrentFnOutput(
        reward=(action == best).float(), discount=torch.zeros(batch),
        prior_logits=torch.zeros((batch, 4)),
        value=torch.zeros(batch)), embedding

  root = RootFnOutput(prior_logits=torch.zeros((4, 4)),
                      value=torch.zeros(4),
                      embedding=torch.tensor([[0.0], [1.0], [2.0], [3.0]]))
  out = muzero_policy((), _gen(0), root, fn, num_simulations=48,
                      dirichlet_fraction=0.0, temperature=0.0)
  np.testing.assert_array_equal(out.action.numpy(), [0, 1, 2, 3])
  # One element alone searches as it does inside the batch (Gumbel is
  # deterministic given its noise).
  gumbel = torch.from_numpy(
      np.random.default_rng(0).gumbel(size=(4, 4)).astype(np.float32))
  full = gumbel_muzero_policy((), _gen(), root, fn, num_simulations=20,
                              gumbel=gumbel)
  for b in range(4):
    one = gumbel_muzero_policy(
        (), _gen(), RootFnOutput(prior_logits=root.prior_logits[b:b + 1],
                                 value=root.value[b:b + 1],
                                 embedding=root.embedding[b:b + 1]),
        fn, num_simulations=20, gumbel=gumbel[b:b + 1])
    assert torch.equal(one.search_tree.children_visits[0],
                       full.search_tree.children_visits[b])
    assert int(one.action[0]) == int(full.action[b])


@pytest.mark.parametrize("kind", ["puct", "pucb", "ucb", "ltr", "pltr",
                                  "pnltr"])
def test_zoo_finds_best_arm(kind):
  select = sel.make_exploration_selection(kind)
  tree = search((), _gen(), root=uniform_root(2, 3),
                recurrent_fn=bandit_recurrent_fn([0.0, 1.0, 0.2]),
                root_action_selection_fn=select,
                interior_action_selection_fn=select, num_simulations=40)
  visits = tree.children_visits[:, ROOT_INDEX]
  assert bool((visits.argmax(-1) == 1).all()), (kind, visits)


def test_zoo_bfs_visits_uniformly_and_respects_root_mask():
  select = sel.make_exploration_selection("bfs")
  tree = search((), _gen(), root=uniform_root(1, 4),
                recurrent_fn=bandit_recurrent_fn([0.0, 1.0, 0.2, 0.4]),
                root_action_selection_fn=select,
                interior_action_selection_fn=select, num_simulations=16,
                max_depth=1)
  visits = tree.children_visits[0, ROOT_INDEX]
  assert int(visits.max() - visits.min()) <= 1
  select = sel.make_exploration_selection("ucb")
  tree = search((), _gen(), root=uniform_root(1, 3),
                recurrent_fn=bandit_recurrent_fn([0.1, 9.0, 0.2]),
                root_action_selection_fn=select,
                interior_action_selection_fn=select, num_simulations=20,
                invalid_actions=torch.tensor([[0.0, 1.0, 0.0]]))
  assert int(tree.children_visits[0, ROOT_INDEX, 1]) == 0


def test_seq_halving_is_the_ports_own():
  assert seq_halving.__name__ == "muax_tpu_torch.search.seq_halving"
