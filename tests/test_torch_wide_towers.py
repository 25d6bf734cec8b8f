"""The plain versions of the MLP search and learner, and of the Stochastic
MuZero search, at ``examples/run_2048.py``'s widths (A = 4, embedding 64,
support 300: 601 bins, towers (256, 256); Stochastic MuZero with 32 chance
outcomes), whose weights no longer fit a block's shared memory, against
the JAX package on the CPU: the searches against the Pallas kernels in
interpret mode (4 envs x 16 simulations, under legal masks), the learner
against the Pallas learner in interpret mode (batch 16, K = 5); and the
tile kernel's towers as each cluster rank's pack holds them.

Tolerances as ``tests/test_fused.py:56-60`` (at most 2 visits apart, root
value rtol = atol = 1e-3, q where the visits agree) and
``tests/test_fused_learner.py:67-79`` (gradients rtol 2e-4 / atol 1e-6,
loss metrics rtol 1e-5, priorities rtol 1e-4); the Stochastic MuZero
search as ``tests/test_fused_smz.py:58-66`` (decision visits within 2,
root values rtol = atol = 1e-3). The kernels' wide modes (the MLP
search's tile kernel, the MLP learner's cluster pass, the SMZ search's
global-weight instance) are held against these plain versions on the card
(``tests/test_torch_fused_search_kernel.py``,
``tests/test_torch_fused_gumbel_kernel.py``,
``tests/test_torch_fused_learner_kernel.py``,
``tests/test_torch_smz_kernels.py``).
"""
import jax.numpy as jnp
import pytest
import numpy as np
import torch

from muax_tpu.models import fused_learner as jfl
from muax_tpu.search import fused as jfused
from muax_tpu.train.inference import make_smz_fns as j_make_smz_fns
from muax_tpu_torch.models import fused_learner, make_stochastic_mlp_networks
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from muax_tpu_torch.search import fused
from tests.test_torch_fused_learner import KW, _assert_metrics_close
from tests.test_torch_fused_search import _check_close
from tests.test_torch_parity import (assert_trees_close, batch_numpy,
                                     jax_batch, nets, torch_batch)
from tests.test_torch_smz_networks import smz_nets

WIDE = dict(num_actions=4, embedding_dim=64, support_size=300,
            repr_layers=(256, 256), pred_layers=(256, 256),
            dyn_layers=(256, 256))
SMZ_WIDE = dict(num_actions=4, num_chance_outcomes=32, embedding_dim=64,
                support_size=300, hidden=(256, 256))


def test_plain_search_matches_jax_kernel_at_2048_widths():
  j_net, j_params, net, params = nets(WIDE, obs_dim=16)
  rng = np.random.default_rng(7)
  B, sims = 4, 16
  emb = rng.uniform(0, 1, (B, 64)).astype(np.float32)
  invalid = np.zeros((B, 4), np.float32)
  invalid[0, 1] = invalid[1, 3] = invalid[2, :2] = 1.0  # board-like masks
  logits = np.where(invalid > 0, -1e9,
                    rng.standard_normal((B, 4))).astype(np.float32)
  value = (rng.standard_normal(B) * 20).astype(np.float32)
  kwargs = dict(num_simulations=sims, support_size=300, discount=0.999,
                max_depth=None)
  ref = jfused.fused_muzero_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_fused_weights(j_net, j_params),
      invalid_actions=jnp.asarray(invalid), **kwargs)
  weights = fused.extract_fused_weights(net, params)
  assert weights.flat().numel() == 492278  # past a block's shared memory
  out = fused.fused_muzero_search(
      torch.from_numpy(emb), torch.from_numpy(logits),
      torch.from_numpy(value), weights,
      invalid_actions=torch.from_numpy(invalid), **kwargs)
  _check_close(*out, *ref, sims)
  assert float(out[0][torch.from_numpy(invalid) > 0].abs().max()) == 0.0


def test_plain_learner_matches_jax_kernel_at_2048_widths():
  j_net, j_params, net, params = nets(WIDE, obs_dim=16)
  arrays = batch_numpy(3, B=16, L=5, obs_dim=16, num_actions=4)
  arrays["rn"] = arrays["rn"] * 10  # returns over many of the 601 bins
  ref_grads, ref = jfl.fused_muzero_grad(
      j_params, jax_batch(arrays), j_net,
      jfl.extract_learner_weights(j_net, j_params), interpret=True, **KW)
  lw = fused_learner.extract_learner_weights(net, params)
  assert lw.flat.numel() == 578870
  grads, metrics = fused_learner.fused_muzero_grad(
      params, torch_batch(arrays), net, lw, **KW)
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  _assert_metrics_close(metrics, ref)


def test_plain_smz_search_matches_jax_kernel_at_2048_widths():
  j_net, j_params, _, net, params = smz_nets(SMZ_WIDE, obs_dim=16)
  rng = np.random.default_rng(7)
  B, sims = 4, 16
  obs = rng.standard_normal((B, 16)).astype(np.float32)
  j_root = j_make_smz_fns(j_net, 0.999)[0](j_params, jnp.asarray(obs))
  invalid = np.zeros((B, 4), np.float32)
  invalid[0, 1] = invalid[1, 3] = invalid[2, :2] = 1.0  # board-like masks
  logits = np.where(invalid > 0, -1e9,
                    np.asarray(j_root.prior_logits)).astype(np.float32)
  value = np.array(j_root.value)
  emb = np.array(j_root.embedding)
  kwargs = dict(num_simulations=sims, support_size=300, discount=0.999,
                max_depth=None)
  ref = jfused.fused_smz_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_smz_fused_weights(j_net, j_params),
      num_chance_outcomes=32, invalid_actions=jnp.asarray(invalid),
      interpret=True, **kwargs)
  weights = fused.extract_smz_fused_weights(net, params)
  assert weights.flat().numel() == 762031  # past a block's shared memory
  visits, root_value, _ = fused.fused_smz_search(
      torch.from_numpy(emb), torch.from_numpy(logits),
      torch.from_numpy(value), weights,
      invalid_actions=torch.from_numpy(invalid), **kwargs)
  ref_visits = np.asarray(ref[0])
  np.testing.assert_allclose(visits.sum(-1).numpy(), sims)
  np.testing.assert_allclose(ref_visits.sum(-1), sims)
  assert np.abs(visits.numpy() - ref_visits).max() <= 2
  np.testing.assert_allclose(root_value.numpy(), np.asarray(ref[1]),
                             rtol=1e-3, atol=1e-3)
  assert float(visits[torch.from_numpy(invalid) > 0].abs().max()) == 0.0


# The kernel's instances (fused.WIDE_INSTANCES: 16 x 16 and 48 x 4) and
# two other cuts of the same packing, by 8 and by 4 ranks.
@pytest.mark.parametrize("tile,cluster,ntw", [(16, 16, 1), (16, 8, 2),
                                              (32, 4, 3), (48, 4, 3)])
def test_wide_pack_holds_every_weight_once_at_2048_widths(tile, cluster,
                                                          ntw):
  # The tile kernel reads the towers as each cluster rank's pack
  # (pack_wide_towers): per phase the rank's columns of the phase's
  # linears side by side, zero past the input rows and the width. Put back
  # together over the ranks, every phase's [in, width] matrix and bias are
  # the towers' own, bit for bit, and the rank-by-rank products add up to
  # the plain layer's.
  _, _, net, params = nets(WIDE, obs_dim=16)
  weights = fused.extract_fused_weights(net, params)
  flat = weights.flat()
  lay = fused.wide_layout(tile, cluster, ntw, 4, 64, 601, 50, (256, 256),
                          (256, 256), False, 2, True)
  pack = fused.pack_wide_towers(flat, cluster, 4, 64, 601, (256, 256),
                                (256, 256)).view(cluster, lay.rank_floats)
  assert pack.shape[1] == lay.rank_floats
  phases = [[weights.dyn_hidden[0]], [weights.dyn_hidden[1]],
            [weights.dyn_reward, weights.dyn_state],
            [weights.pred_hidden[0]], [weights.pred_hidden[1]],
            [weights.pred_value, weights.pred_policy]]
  rng = np.random.default_rng(3)
  for p, linears in enumerate(phases):
    W = torch.cat([w for w, _ in linears], 1)
    b = torch.cat([bias for _, bias in linears])
    d_in, width, nb, in8 = lay.ins[p], lay.widths[p], lay.nb[p], lay.in8[p]
    got_w = torch.cat([pack[r, lay.w_off[p]:lay.w_off[p] + in8 * nb]
                       .view(in8, nb) for r in range(cluster)], 1)
    got_b = torch.cat([pack[r, lay.b_off[p]:lay.b_off[p] + nb]
                       for r in range(cluster)])
    assert torch.equal(got_w[:d_in, :width], W)
    assert torch.equal(got_b[:width], b)
    assert not got_w[d_in:].any() and not got_w[:, width:].any()
    assert not got_b[width:].any()
    x = torch.from_numpy(rng.standard_normal((tile, in8)).astype(np.float32))
    x[:, d_in:] = 0.0
    parts = torch.cat([x @ got_w[:, r * nb:(r + 1) * nb]
                       for r in range(cluster)], 1)[:, :width]
    torch.testing.assert_close(parts + b, x[:, :d_in] @ W + b, rtol=0,
                               atol=0)


def _rank_cols(pack, off, rows, nb, width):
  """A part's [rows, width] block put back together over the ranks."""
  return torch.cat([pack[r, off:off + rows * nb].view(rows, nb)
                    for r in range(pack.shape[0])], 1)[:, :width]


# The SMZ tile kernel's instances (fused.SMZ_WIDE_INSTANCES).
@pytest.mark.parametrize("tile,cluster,ntw", [(16, 16, 1), (48, 4, 3)])
def test_smz_wide_parts_compute_the_towers_at_2048_widths(tile, cluster,
                                                          ntw):
  # The SMZ tile kernel's parts run in the layout's order on its buffers
  # (X, the two hidden buffers, the owners' logits), each part's weights,
  # one-hot rows and biases read from every rank's pack
  # (pack_smz_wide_towers): under a decision parent the decision tower's
  # heads, under a chance parent the chance tower's next state and reward,
  # then the prediction tower's policy and value on the normalised next
  # state, as the plain version computes them (f32 products summed in
  # another order: rtol = atol = 1e-5).
  A, C, E, S = 4, 32, 64, 601
  net = make_stochastic_mlp_networks(device="cpu", **SMZ_WIDE)
  params = net.init_params((16,), torch.Generator().manual_seed(3))
  weights = fused.extract_smz_fused_weights(net, params)
  widths = fused._smz_widths(weights)
  lay = fused.smz_wide_layout(tile, cluster, ntw, A, C, E, S, 200, 200,
                              *widths, 0, 2)
  pack = fused.pack_smz_wide_towers(weights.flat(), cluster, A, C, E, S,
                                    *widths).view(cluster, -1)
  assert pack.shape[1] == lay.rank_floats
  rng = np.random.default_rng(5)
  x = torch.from_numpy(rng.uniform(0, 1, (tile, E)).astype(np.float32))
  hot = torch.from_numpy(rng.integers(0, A + C, tile))
  dec, ch = hot < A, hot >= A
  X = x.clone()
  H = [torch.zeros(tile, 256), torch.zeros(tile, 256)]
  L = torch.zeros(tile, E + C + S)
  heads = {}
  for k, part in enumerate(lay.parts):
    src = X if part.src == fused._BUF_X else H[part.src - fused._BUF_H0]
    W = _rank_cols(pack, part.w_off, part.in8, part.nb, part.width)
    b = _rank_cols(pack, part.b_off, 1, part.nb, part.width)[0]
    v = src[:, :part.ins] @ W[:part.ins]
    if part.hot != fused._HOT_NONE:
      rows = A if part.hot == fused._HOT_ACTION else C
      hot_w = _rank_cols(pack, part.h_off, rows, part.nb, part.width)
      keep = dec if part.hot == fused._HOT_ACTION else ch
      v[keep] += hot_w[(hot - (0 if part.hot == fused._HOT_ACTION else A))
                       [keep]]
    v = v + b
    if part.kind == fused._HIDDEN:
      H[part.dst - fused._BUF_H0][:, :part.width] = (
          torch.nn.functional.elu(v))
    elif part.kind == fused._DEC_HEADS:
      L[dec, :part.width] = v[dec]
    elif part.kind == fused._CH_HEADS:
      X[:, :E] = v[:, :E]
      L[ch, :S] = v[ch, E:]
    else:
      heads["pred"] = v
    if k == lay.mid:
      heads["dec"], heads["reward"] = L[dec].clone(), L[ch, :S].clone()
      lo, hi = X.amin(-1, keepdim=True), X.amax(-1, keepdim=True)
      X = (X - lo) / torch.clamp(hi - lo, min=1e-8)
      heads["state"] = X[ch].clone()

  def tower(inp, layers):
    for w, bias in layers:
      inp = torch.nn.functional.elu(inp @ w + bias)
    return inp

  def head(h, linear):
    return h @ linear[0] + linear[1]

  one_hot = torch.nn.functional.one_hot
  h = tower(torch.cat([x, one_hot(hot.clamp(max=A - 1), A).float()], -1),
            weights.dec_layers)[dec]
  want = torch.cat([head(h, weights.dec_state), head(h, weights.dec_chance),
                    head(h, weights.dec_value)], -1)
  close = dict(rtol=1e-5, atol=1e-5)
  torch.testing.assert_close(heads["dec"], want, **close)
  h = tower(torch.cat([x, one_hot((hot - A).clamp(min=0), C).float()], -1),
            weights.ch_layers)[ch]
  state = head(h, weights.ch_state)
  lo, hi = state.amin(-1, keepdim=True), state.amax(-1, keepdim=True)
  state = (state - lo) / torch.clamp(hi - lo, min=1e-8)
  torch.testing.assert_close(heads["state"], state, **close)
  torch.testing.assert_close(heads["reward"], head(h, weights.ch_reward),
                             **close)
  g = tower(state, weights.pred_layers)
  torch.testing.assert_close(
      heads["pred"][ch], torch.cat([head(g, weights.pred_policy),
                                    head(g, weights.pred_value)], -1), **close)
