"""Smoke run of the PyTorch port (``muax_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

  python3 chip_smoke.py

Phase 0 builds every CUDA kernel of the port from the sources in the
checkout, one ``nvcc`` per source, all at once, and prints each kernel's
registers and spill bytes as ``ptxas`` reports them. Phases 1 and 2 hold the
search kernel against its plain PyTorch version at the rollout's shapes and
at edge shapes; phase 1 also holds the kernel with every lane-group size
G at the rollout's shape. Phase 3 drives self-play, MuZero on CartPole (``make_rollout_fn`` at 8192
envs x 64 simulations x 20 steps, the rollout of ``bench.py``'s default
run), counts the kernel launches it makes and checks what it returns; then
it times the search kernel and its plain version on the inputs of that run,
at 8192 envs and on the first 1024 of them (the training iteration's
batch), with the launch plan and the theoretical warps per SM of each.

Phases 4 to 7 do the same for training, at ``bench.py``'s
``training_regime`` (1024 envs x 64 simulations x 20 steps, batch 4096,
samples per insert 32 -> 160 updates in groups of 16, ring of 2048
segments, unroll 5). Phase 4 holds the sampler kernel against its plain
version on a ring filled by the port's own rollouts (65,536 windows), then
at an edge shape; phase 5 holds the learner kernels (the MLP spec's tile
pass and finish pass) against their plain version (autograd over
``muzero_loss``) on phase 4's windows, at an edge shape, on the CartPole
notebook's towers (64, 64, 16) at K = 11, whose arena lies in the device
scratch, and on wide towers (128,), and checks that a repeated launch gives
bit-identical gradients.
Phase 6 drives the training iteration (rollout -> ``replay_add`` ->
``make_multi_update_fn``), checks its launch counts exactly and times it and
each kernel (the learner with CUDA events, each of its two kernels with
``torch.profiler``, its bound, launch plan and theoretical warps per SM).
Phase 7 runs ``fit`` through its normal entry for 3 iterations with
evaluation and checkpoints.

Phases 8 to 11 drive Gumbel MuZero and the generic search engine. Phase 8
holds the search kernel's Gumbel mode against its plain version at 8192
envs x 64 simulations (A = 2, at most 16 considered actions) and at an edge
shape (1003 envs, A = 4 with one invalid action, so 3 considered, depth cap
2, towers (16, 16)), and with every G at 8192 envs, and checks that the
policy's action agrees. Phase 9 drives ``make_rollout_fn`` with
``policy="gumbel"`` at ``bench.py``'s ``gumbel_mlp`` (8192 envs x 64
simulations x 20 steps): exactly 20 Gumbel launches and no MuZero launch per
rollout; it times the kernel at 8192 and 1024 envs as phase 3 does. Phase
10 drives the training iteration at ``gumbel_training`` (1024 envs, batch
4096, samples per insert 32, presample 16): exactly 20 + 10 + 160
launches. Phase 11 runs one policy
step of the generic engine (``search.fused=False``) for each policy at 1024
envs x 64 simulations on the card: no kernel launch, and visits within 2 of
the kernel's.

Phases 12 to 15 drive the acme categorical family (``bench.py``'s
``make_networks("categorical")``: embedding 64, LayerNormMLP towers (256,
256, 256), 51 linear bins over +-150) through the categorical modes of the
search kernel and the categorical learner's two kernels (all on the
tensor cores, 3xTF32). Phase 12 holds both policy modes of the search kernel
against their plain version at ``muzero_categorical``'s shape (2048 envs x
64 simulations, A = 2), at ``categorical_training``'s 512 envs and at an
edge shape (1003 envs, A = 3 with an invalid action, depth cap 2, towers
(48, 32), 21 bins), and at 2048 envs with A = 18, whose trees the kernel
keeps in the device scratch rather than in shared memory, and times that
instance. Phase 13 drives ``make_rollout_fn`` at
``muzero_categorical`` (2048 envs x 64 simulations x 20 steps) in each
policy: exactly 20 launches of that mode and none of the others per
rollout; it times the kernel at 2048 and at 512 envs. Phase 14 holds the
categorical learner (its per-tile pass and its weight-gradient pass)
against autograd over the categorical ``muzero_loss`` on 1024 windows
sampled from a ring of the family's own rollouts, and at an edge shape,
with bit-identical repeats, and times the two kernels together and each
alone. Phase 15 drives one training iteration at ``categorical_training``
(512 envs x 64 simulations x 20 steps, batch 1024, samples per insert 32,
presample 16): exactly 20 + 20 + 320 launches, timed and profiled.

Phases 16 to 20 drive Stochastic MuZero (``bench.py``'s ``smz_mlp`` five
nets: 32 chance outcomes, embedding 32, hidden (64,)). Phase 16 holds the
forest search kernel against its plain version at ``stochastic_200sims``
(256 envs x 200 simulations), at 512 envs, on a deep-tree net (one action
and one outcome made to dominate, so that the simulations extend one
chain; 64 envs, with and without ``max_depth=32``) and at an edge shape,
each with a repeated launch that must give the same bits. Phase 17 drives
``make_rollout_fn`` at ``stochastic_200sims`` (exactly 20 launches and no
other search mode) and times the kernel, with its launch plan, registers
and theoretical warps per SM. Phase 18 holds the sampler's
``per_step_obs`` mode against its plain version at W = 16,384, phase 19
drives one ``smz_training`` iteration (exactly 20 + 10 + 0 launches: the
hybrid feed runs autograd) and phase 20 runs ``fit`` with a resume.

Phases 21 to 24 drive reanalyze, legal-action masks, AlphaZero and the env
models. Phase 21 runs ``make_reanalyze_fn`` on the ring that phase 6 filled
(64 segments of 20 steps a call, at 64 and at 16 simulations): exactly one
MLP search launch a call, held against the plain version on its own
inputs (envs shown to be near-ties excused, on at most 5 %: ``tie_proof``),
the refreshed slots stamped with the step, every other slot
unchanged, a segment drawn twice giving bit-identical rows; it times the
call and the kernel at 1280 envs; then ``fit`` runs 3 iterations with
``reanalyze_every=1``, each making exactly the training iteration's
launches and one reanalyze search. Phase 22 drives ``make_rollout_fn`` on
Connect Four (A = 7) at 8192 envs and on TicTacToe (A = 9) at 1003 envs,
64 simulations x 21 steps, in each policy: exactly 21 launches of the
policy's mode, every action legal under the mask read before its step, no
weight on an illegal action, and the last step's masked launch against the
plain version, with the plan ``mlp_search_plan`` chose. Phase 23 runs
AlphaZero on Connect Four at ``bench.py``'s ``alphazero_connect4`` through
the generic engine (no kernel launch): moves/s, simulations/s, updates/s,
the device's idle share, and 64 games against a random player. Phase 24
steps the simulator's and the learned model's policies on Catch at 1024
envs and trains the transition model for 10 SGD steps (no kernel launch).

Phases 25 to 29 drive the conv and pixel path at ``bench.py``'s EZ width
(``PixelCatch`` 10 x 5 at scale 8: 80 x 40 x 1 uint8 frames, 3 actions;
the EfficientZero triplet at 32 channels, 2 blocks, downsampled). Phase 25
holds the sampler kernel on a uint8 ring (PixelCatch at scale 1, 50
features, W = 16,384, both modes) against its plain version and against
itself on the ring cast to f32 (bit-identical rows), timed on both rings.
Phase 26 holds the EZ triplet and the ResNet triplet (64 channels, 4
blocks, Connect Four planes) on the card against the same weights on the
CPU: outputs and one ``muzero_loss`` gradient, rtol 1e-4 / atol 1e-5 (the
ResNet's gradient under cuDNN within ``RESNET_CUDNN_GRAD_SHARE`` of its
largest entry).
Phase 27 drives ``make_rollout_fn`` at ``muzero_ez_conv_pixel`` (512 envs x
32 simulations x 20 steps) through the generic engine, phase 28 the
rollout of ``ez_conv_training`` (256 envs) and one group of updates each
of it and of ``ez_conv_training_b1024`` (batch 256 and 1024: the ring's
3200 features take ``replay_sample``, as ``fused_status`` says), with the
iteration's time from the measured ms an update, and one gradient step in
bf16 with remat against f32, both with no launch of any kernel
(``tools/ez_phases.py --full`` runs the whole iterations); phase 29 runs
``fit`` for 2 iterations on uint8 PixelCatch at scale 1 with the triplet
undownsampled, the hybrid route through the sampler kernel on a uint8 ring
(one launch a group).

Phase 30 drives the host-environment path at ``examples/run_2048.py``'s
full width (``muax_tpu_torch/examples/run_2048.py``: the native 2048 pool,
the MLP triplet at embedding 64, support 300 and towers (256, 256), whose
weights exceed a block's shared memory). It holds the search kernel's
wide mode (``fused_search_wide_kernel``: tiles of environments sharing
every tower read), MuZero and Gumbel, against its plain version at 64 and
1024 boards x 50 simulations on the legal masks of real boards (phase 22's
rule for masked roots, a repeated launch bit-identical), and the learner's
wide mode (the cluster pass ``mlp_cluster_kernel``, then the weight-
gradient pass) against autograd over ``muzero_loss`` at batch 256, K = 5
(phase 5's tolerances, the scratch filled with NaN, a repeated launch
bit-identical), each timed with its plan (the runtime's clusters at once),
its bound in f32 FMA and 3xTF32 and its weight bytes. Then ``fit`` runs on
the pool at the example's
config (64 boards, an evaluation pool of 16 at seed + 10,000, 32 steps an
iteration, batch 256, 16 updates, ring 2048, min_fill 128) for
``HOST_ITERATIONS`` iterations after its warm-up, under ``torch.profiler``
(device activity): exactly the search, sampler and learner launches the
config implies and no other mode, every search launch the tile kernel's
and every update the cluster pass's, every action legal under its mask,
finite losses; ms an iteration, env-steps/s, the host's part of a step
(the pool's C++ step, the copies) and the device's idle share.

Phase 31 drives the host-facing surface, on which no kernel runs (the JAX
agents, too, search with the generic engine and learn with autograd): every
kernel's launch count is set to 0 before it and must be 0 after. Sampled
MuZero on ``tests/test_sampled.py``'s Gaussian bandit and delayed-reward
case at 1024 roots x 64 simulations (every root's best slot has the most
visits, and the pick is it or a slot that ties it); the MuZero agent at
the CartPole notebook triplet in the reference's single-env workflow
(CartPole on the card, ``act`` at 50 simulations, ``PNStep`` into
``Trajectory`` into ``TrajectoryReplayBuffer``, three episodes of at most
100 steps, ``TrainMonitor(None)`` and ``Stopwatch``), 20 updates of 256
windows (the loss on a fixed batch falls), one update on the card and the
CPU from the same state (rtol 1e-4 / atol 1e-6, TF32 off), save and load
(the same action, pi and value for the same seed) and a batched ``act``
over 256 observations with its launches and idle share; the Stochastic
MuZero agent (``smz_mlp`` widths, 200 simulations) and the Diffusion MuZero
agent (its defaults, 50 simulations) act over 64 observations (the weights
sum to 1) and update on that buffer (the diffusion agent's flow loss
before and after, and one update on the card and the CPU with the same
injected flow draws). ``tools/agents_phase.py`` runs it alone.

Phase 32 drives the parallel layer (``muax_tpu_torch/parallel``) over
``torch.distributed``, its ranks spawned with a file rendezvous and killed
past a timeout (``tools/parallel_phase.py`` runs it alone). (a) The sharded
program (``make_sharded_program``, the global config of phase 6) on a
world of one through NCCL: exactly 20 + 10 + 160 launches an iteration,
its iteration ms beside phase 6's, the NCCL all-reduce's ms at the flat
gradient's size. (b) Two ranks sharing the one card through gloo, each
with 512 envs, batch 2048 and a ring of 1024: exactly 20 + 10 + 160
launches an iteration on each rank, the parameters and optimizer state
bit-identical across the ranks after every iteration, each rank's
``total_added`` its envs times the iterations, the pair's env-steps/s and
the gloo all-reduce's ms (through host memory: no NCCL figure, and no
figure of several cards). (c) One update's reduced gradient equals the
mean of the two ranks' own gradients bit for bit. (d) Reanalyze of 64
segments over the two ranks: 64 summed, each ring's newest stamp the
step, its pi changed. (e) The AlphaZero Go tower (``make_az_resnet(362,
256, 19)``, 19 x 19 x 17 planes, batch 8) with its channels split over the
model axis against the replicated apply (rtol 1e-4 / atol 1e-5, TF32
off), and the ms of both.

Phase 33 holds the Stochastic MuZero search's wide-tower kernel
(``fused_smz_wide_kernel``: towers past a block's shared memory, tiles of
environments sharing every tower read) against its plain version at
``examples/run_2048.py``'s widths (A = 4, 32 chance outcomes, embedding
64, support 300, hidden (256, 256): 3.05 MB of towers), on 64 and 1024
boards of the native pool x 200 simulations under their legal masks, by
phase 22's rule with phase 21's ulp proof of near-ties
(``compare_masked_smz``), a repeated launch bit-identical; it prints the
plan, ms, plain ms, the f32 and 3xTF32 bounds and the tower bytes read
from L2 (modelled per tile and simulation), and drives
``make_policy_fn(policy="stochastic")`` over the net with exactly one wide
SMZ launch a call. Phase 34 runs the port's example scripts'
``main`` (``muax_tpu_torch/examples``) for two iterations each at their
default widths (the generic-engine scripts at 8 simulations): the
fit-based ones (CartPole, the acme regime, 2048 on the native pool, whose
launches all go through the wide kernels, pixel Catch, fake Atari) with
fit's status pinned, every kernel's launches held to fit's schedule and,
where the kernels run, each kernel's first launch inside the script held
against its plain version; the AlphaZero and MCTS scripts with none;
LunarLander only where gymnasium with Box2D imports.
``tools/examples_phase.py`` runs both alone.

Every failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card, or without the package beside it, it fails the same way.
The line before the last lists every kernel with its launches, error, times
and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": <cards>}}.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

SEED = 0
# The main path: bench.py's default rollout (flagship MLP triplet, CartPole).
MAIN_ENVS, MAIN_SIMS, MAIN_STEPS = 8192, 64, 20
EMBED, SUPPORT = 8, 20
# Edge shapes: a batch that does not fill the kernel's last block.
EDGE_ENVS = 1003
WARMUP_ROLLOUTS, TIMED_ROLLOUTS = 2, 3
# The training path: bench.py's training_regime (bench.py:463-467).
TRAIN_ENVS, TRAIN_BATCH, TRAIN_SPI, TRAIN_PRESAMPLE = 1024, 4096, 32.0, 16
TRAIN_CAPACITY, TRAIN_UNROLL, TRAIN_NSTEP = 2048, 5, 10
TRAIN_UPDATES = -(-int(TRAIN_SPI) * TRAIN_ENVS * MAIN_STEPS // TRAIN_BATCH)
TRAIN_GROUP = 16  # gcd(160, 16)
WARMUP_ITERATIONS, TIMED_ITERATIONS = 2, 3
# The acme categorical family: bench.py's make_networks("categorical") and
# its muzero_categorical (bench.py:310-313) and categorical_training
# (bench.py:351-354) regimes.
CAT_NET = dict(embedding_dim=64, layer_sizes=(256, 256, 256), num_bins=51,
               vmin=-150.0, vmax=150.0)
CAT_EDGE_NET = dict(embedding_dim=16, layer_sizes=(48, 32), num_bins=21,
                    vmin=-10.0, vmax=10.0)
CAT_ENVS = 2048
CAT_TRAIN_ENVS, CAT_BATCH = 512, 1024
CAT_UPDATES = -(-int(TRAIN_SPI) * CAT_TRAIN_ENVS * MAIN_STEPS // CAT_BATCH)
# Stochastic MuZero: bench.py's make_networks("smz_mlp") (bench.py:80-83)
# and its stochastic_200sims (bench.py:328-331) and smz_training
# (bench.py:367-373) regimes.
SMZ_NET = dict(num_chance_outcomes=32, embedding_dim=32, support_size=20,
               hidden=(64,))
SMZ_EDGE_NET = dict(num_chance_outcomes=4, embedding_dim=8, support_size=10,
                    hidden=(16, 16))
SMZ_ENVS, SMZ_SIMS, SMZ_EDGE_ENVS = 256, 200, 37
# stochastic_200sims_512 (bench.py), and the deep-tree net's envs (few, so
# that the plain version's lockstep walks stay within seconds), its bias on
# one entry of the policy head's and of the chance head's bias, and the
# production depth cap (bench.py's smz_training_depth32).
SMZ_LARGE_ENVS, SMZ_DEEP_ENVS, SMZ_DEEP_BIAS, SMZ_DEPTH_CAP = 512, 64, 8.0, 32
SMZ_BATCH, SMZ_PRESAMPLE = 256, 64
SMZ_PROFILE_UPDATES = 16
SMZ_UPDATES = -(-int(TRAIN_SPI) * SMZ_ENVS * MAIN_STEPS // SMZ_BATCH)
# Published peaks of the H100 SXM (NVIDIA's data sheet): f32 outside the
# tensor cores, and HBM3; the categorical kernels' products run on the
# tensor cores in TF32 three times over (3xTF32), so their f32 operations
# bound at a third of the 495 TFLOP/s TF32 rate.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# The acme categorical family's search at categorical_training's envs.
CAT_SEARCH_SMALL_ENVS = 512
# Actions at which eight trees of 64 simulations no longer fit a block's
# shared memory beside the activation rows (an Atari-sized action set), so
# that the search keeps its trees in the device scratch at CAT_ENVS.
SCRATCH_TREE_ACTIONS = 18
# Reanalyze on training_regime's ring: segments a call (x 20 steps = 1280
# positions), and the reduced budget of the second call.
REANALYZE_SEGMENTS, REANALYZE_SIMS = 64, 16
# The board games' masked rollouts: 21 moves, half a Connect Four game.
BOARD_STEPS = 21
# bench.py's alphazero_connect4 (bench.py:236-291): 256 games x 64
# simulations, 21 moves an iteration; two timed iterations after one
# warm-up (three until phase 30 joined the script's time limit), and the
# evaluation against a random player over 64 games.
AZ_ENVS, AZ_MOVES, AZ_TIMED, AZ_EVAL_GAMES = 256, 21, 2, 64
# The conv and pixel path: bench.py's make_networks("ez_conv") on
# make_env("ez_conv") (bench.py:76-78, 92-97): PixelCatch 10 x 5 at scale 8
# (80 x 40 x 1 uint8 frames), 3 actions, the EfficientZero triplet at 32
# channels, 2 blocks, support 20, downsampled; its muzero_ez_conv_pixel
# (512 envs x 32 simulations, bench.py:314-317), ez_conv_training and
# ez_conv_training_b1024 (256 envs, samples per insert 32, presample 64,
# batch 256 and 1024, bench.py:335-350). The uint8 sampler phases use
# PixelCatch 10 x 5 at scale 1 (50 features, under the learner gate's 64).
EZ_NET = dict(support_size=20, channels=32, num_blocks=2)
EZ_FRAME, EZ_SMALL_FRAME = (80, 40, 1), (10, 5, 1)
EZ_ROLLOUT_ENVS, EZ_SIMS = 512, 32
EZ_TRAIN_ENVS, EZ_PRESAMPLE, EZ_BATCHES = 256, 64, (256, 1024)
EZ_GROUP_WINDOWS = 16384
# Updates under the profiler, for the idle share and launches an update.
EZ_PROFILE_UPDATES = 8
# Phase 29 runs fit's route, not a regime: 64 envs x 8 simulations, two
# groups of 64 updates of 256 windows an iteration.
EZ_FIT_ENVS, EZ_FIT_SIMS = 64, 8
# The ResNet triplet at its defaults (64 channels, 4 blocks) on Connect
# Four's planes.
RESNET_NET, RESNET_PLANES = dict(support_size=20, channels=64,
                                 num_blocks=4), (6, 7, 2)
# Phase 26's limit on the ResNet's gradient under cuDNN, as a share of its
# largest entry: on an H100 cuDNN's f32 algorithms read 1.5e-4 of it, TF32
# convolutions and matmuls 1.6e-2 and bf16 compute 2.5e-2
# (tools/conv_precision.py).
RESNET_CUDNN_GRAD_SHARE = 1e-3
# The figures of phase 30's search checks that the kernel line keeps.
WIDE_KEYS = ("ms", "plain_ms", "bound_ms", "bound_ms_3xtf32", "bound_by",
             "max_abs_err", "weight_bytes_requested",
             "weight_bytes_from_l2", "plan")
# Phase 30, the host-environment path: examples/run_2048.py's 64 boards x
# 50 simulations (its networks and config from
# muax_tpu_torch/examples/run_2048.py), the kernels held at 64 and 1024
# boards taken after HOST_BOARD_MOVES random legal moves (so that masks
# have illegal moves), the learner at the example's batch 256 and unroll
# 5; fit for HOST_ITERATIONS iterations after its two warm-up rollouts.
HOST_ENVS, HOST_CHECK_ENVS, HOST_SIMS = 64, 1024, 50
HOST_BOARD_MOVES, HOST_ITERATIONS = 24, 4
HOST_BATCH, HOST_UNROLL = 256, 5
# Phase 31, the host-facing surface (no kernel on its path). Sampled
# MuZero: tests/test_sampled.py's Gaussian-proposal bandit (K = 4) and
# delayed-reward case (K = 2, max depth 2) at 1024 roots x 64 sims. The
# MuZero agent at the CartPole notebook triplet (examples/run_cartpole.py:
# 44-55: embedding 10, support 20, no representation layer, towers
# (64, 64, 16), its optimizer, unroll 10) in the single-env workflow:
# AGENT_EPISODES episodes of at most AGENT_EPISODE_CAP steps at 50 sims, then
# AGENT_UPDATES updates of 32 trajectories x 8 windows, and one batched act
# over 256 observations. Stochastic MuZero at bench.py's smz_mlp widths
# (bench.py:80-83) and Diffusion MuZero at make_diffusion_mlp_networks'
# defaults act over 64 observations and update on the MuZero agent's
# buffer.
SAMPLED_ROOTS, SAMPLED_SIMS = 1024, 64
AGENT_NET = dict(embedding_dim=10, support_size=20, repr_layers=(),
                 pred_layers=(64, 64, 16), dyn_layers=(64, 64, 16))
AGENT_OPTIMIZER = dict(peak_lr=2e-2, end_lr=1e-4, warmup_steps=2000,
                       transition_steps=10000, decay_rate=0.8)
AGENT_UNROLL, AGENT_SIMS, AGENT_DISCOUNT = 10, 50, 0.997
AGENT_EPISODES, AGENT_EPISODE_CAP = 3, 100
AGENT_TRAJECTORIES, AGENT_WINDOWS, AGENT_UPDATES = 32, 8, 20
AGENT_BATCH_OBS, SURFACE_OBS = 256, 64
SMZ_AGENT_UPDATES, DMZ_AGENT_UPDATES = 5, 20
# Phase 32, the parallel layer: (a) the sharded program at training_regime
# on a world of one through NCCL; (b)-(e) PAR_RANKS ranks sharing the one
# card through gloo (each 512 envs, batch 2048, ring 1024) for
# PAR_GLOO_ITERATIONS iterations (the first a warm-up), reanalyze of
# PAR_REANALYZE_SEGMENTS segments over the ranks, and the AlphaZero Go
# tower (make_az_resnet(362, 256, 19), 19 x 19 x 17 planes) at batch
# GO_BATCH split over the model axis. A group that outlives PAR_TIMEOUT_S
# is killed and fails the phase. This torch's gloo takes CUDA tensors in
# all-reduce, broadcast and all-gather, so (e) runs on a (1, PAR_RANKS)
# mesh of the gloo ranks. PAR_SPLIT_UPDATES: the updates (one group) timed
# with and without the learner's all-reduce.
PAR_RANKS, PAR_GLOO_ITERATIONS, PAR_REANALYZE_SEGMENTS = 2, 4, 64
PAR_TIMEOUT_S, PAR_ALL_REDUCE_REPS, PAR_SPLIT_UPDATES = 300, 50, 16
GO_ACTIONS, GO_CHANNELS, GO_BLOCKS = 19 * 19 + 1, 256, 19
GO_PLANES, GO_BATCH, GO_REPS = (19, 19, 17), 8, 5
# Phase 33, Stochastic MuZero at examples/run_2048.py's widths (A = 4, 32
# chance outcomes: 2048's spawns, 16 cells x the tiles 2 and 4; embedding
# 64, support 300, hidden (256, 256)): 762,031 floats of towers, past a
# block's shared memory; 64 and 1024 boards of the native pool x 200
# simulations (bench.py's SMZ budget), the example's discount; the policy
# called SMZ_WIDE_POLICY_CALLS times.
SMZ_WIDE_NET = dict(num_chance_outcomes=32, embedding_dim=64,
                    support_size=300, hidden=(256, 256))
SMZ_WIDE_FLOATS, SMZ_WIDE_ENVS, SMZ_WIDE_DISCOUNT = 762031, (64, 1024), 0.999
SMZ_WIDE_REPS, SMZ_WIDE_POLICY_CALLS = 3, 2
# Phase 34, the example scripts on the card at their default widths, envs
# and batches for EXAMPLE_ITERATIONS iterations; the scripts that search
# with the generic engine (pixel, Atari, AlphaZero, MCTS: about 20 ms a
# simulation of host-bound launches) at EXAMPLE_GENERIC_SIMS simulations,
# so that the phase stays within a minute.
EXAMPLE_ITERATIONS, EXAMPLE_GENERIC_SIMS = 2, 8


def check(cond, message):
  if not cond:
    raise RuntimeError(f"check failed: {message}")


def card_line():
  """The card's name and power limit, as nvidia-smi prints them."""
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
  """Mean device time of ``fn`` over ``reps`` calls, after one warm-up, with
  CUDA events around the whole run."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def once_ms(fn):
  """Device time of one call of ``fn`` with CUDA events, no warm-up: for
  the plain versions at phase 30's widths, which have just run on the same
  inputs and take seconds."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end)


def search_macs(weights):
  """Multiply-adds of one expansion: every linear of both towers, for the
  MLP triplet's weights or a categorical FusedNetSpec."""
  if hasattr(weights, "layers"):
    linears = [w for w, _ in weights.layers()]
  else:
    linears = [ts[0] for _, ts in weights.dyn_layers + weights.pred_layers]
    linears += [weights.dyn_reward[0], weights.dyn_state[0],
                weights.pred_value[0], weights.pred_policy[0]]
  return sum(w.shape[0] * w.shape[1] for w in linears)


def search_bound_ms(batch, sims, weights, with_invalid, gumbel=False,
                    peak=PEAK_F32_FLOPS):
  """Least time for one search launch: the larger of its operations over
  ``peak`` and its bytes over the memory rate. Operations are the two
  towers' multiply-adds, once per expansion (batch x sims expansions); bytes
  are each input read once and each output written once. The Gumbel mode
  also reads the root score [B, A] and the schedule [B, sims]."""
  flops = 2.0 * search_macs(weights) * batch * sims
  num_actions = weights.pred_policy[0].shape[1]
  embed = weights.dyn_state[0].shape[1]
  floats = batch * (embed + num_actions + 1)       # roots
  floats += batch * num_actions * with_invalid     # invalid mask
  floats += weights.flat().numel()
  floats += batch * (2 * num_actions + 1)          # visits, value, q
  floats += batch * (num_actions + sims) * gumbel  # root score, schedule
  t_ops = flops / peak * 1e3
  t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_search(out, ref, sims, invalid=None, tie_proof=None):
  """Kernel against plain: visits sum to ``sims``; at least 99 % of envs
  within 2 visits of the plain version, their root values within
  rtol = atol = 1e-3, and, where the visits agree exactly, the root q within
  the same. A score tie that f32 rounding breaks the other way moves a
  visit, and the subtree under it differs from then on. With
  ``tie_proof`` (envs -> which of them are near-ties, as the function
  ``tie_proof`` gives it) an env within 2 visits may leave the value or q
  tolerance when it is shown to be a near-tie, on at most 5 % of envs:
  deep trees of a trained net meet ties below the root, which move its
  values while its visits stay (phase 21's rings have shown up to 1.8 %
  of envs that an ulp moves past the tolerance)."""
  visits, value, q = out
  ref_visits, ref_value, ref_q = ref
  check(bool((visits.sum(-1) == sims).all()), "visits sum to num_simulations")
  check(bool((ref_visits.sum(-1) == sims).all()),
        "plain visits sum to num_simulations")
  dv = (visits - ref_visits).abs().amax(-1)
  near, exact = dv <= 2, dv == 0
  share = float(near.float().mean())
  check(share >= 0.99, f"{share:.4f} of envs within 2 visits (need 0.99)")
  ties = 0
  if tie_proof is not None:
    off = near & (outside(value, ref_value) | (
        exact & outside(q, ref_q).any(-1)))
    idx = torch.nonzero(off)[:, 0]
    ties = len(idx)
    check(ties <= 0.05 * len(value), f"{ties} envs within 2 visits leave "
          "the value or q tolerance (at most 5 % may, as near-ties)")
    if ties:
      proven = tie_proof(idx)
      check(bool(proven.all()), f"{int((~proven).sum())} of the {ties} "
            "envs that leave the value or q tolerance are not shown to be "
            "near-ties")
    near, exact = near & ~off, exact & ~off
  check(torch.allclose(value[near], ref_value[near], rtol=1e-3, atol=1e-3),
        "root values agree")
  check(torch.allclose(q[exact], ref_q[exact], rtol=1e-3, atol=1e-3),
        "root q agree where visits agree")
  if invalid is not None:
    check(float(visits[invalid > 0].abs().max()) == 0.0,
          "invalid actions get no visits")
  err = max(float((value[exact] - ref_value[exact]).abs().max()),
            float((q[exact] - ref_q[exact]).abs().max()))
  figures = {"within_2_visits": share, "exact_visits": float(
      (dv == 0).float().mean()), "max_abs_err": err}
  if tie_proof is not None:
    figures["near_ties"] = ties
  return figures


def outside(a, b):
  """Where ``a`` leaves rtol = atol = 1e-3 of ``b``."""
  return (a - b).abs() > 1e-3 + 1e-3 * b.abs()


def tensor_map(fn, tree):
  """``fn`` over every tensor of a tree of (named) tuples of tensors."""
  if isinstance(tree, tuple):
    items = [tensor_map(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
  return fn(tree)


def sub_launch(args, kwargs, idx):
  """A recorded MLP search launch's inputs (MuZero's, or Gumbel's with its
  root score and schedule) for the envs ``idx`` alone."""
  B = args[0].shape[0]

  def pick(x):
    return x[idx].contiguous() if torch.is_tensor(x) and x.shape[0] == B \
        else x

  return (tuple(pick(a) for a in args[:3]) + (args[3],),
          {k: pick(v) for k, v in kwargs.items()})


def ulp_sensitive(args, kwargs, idx, trials=8, weights=True, runs=None):
  """Which of the envs ``idx`` of a recorded search launch (MLP, or
  Stochastic MuZero with ``runs=(smz_reference, smz_cuda)``) are
  near-ties: their inputs alone, launched as a batch of their own in the
  plain version and in the kernel, then again ``trials`` times with every
  element of their root embeddings, and with ``weights`` of the towers'
  weights, stepped one ulp up or down (a seeded sign each); an env is a
  near-tie when, in either, a nudge moves its root value or a root q past
  rtol = atol = 1e-3."""
  sub_args, sub_kwargs = sub_launch(args, kwargs, idx)
  gen = torch.Generator().manual_seed(SEED)

  def nudge(t):
    up = (torch.rand(t.shape, generator=gen) < 0.5).to(t.device)
    return torch.where(up, torch.nextafter(t, torch.full_like(t, math.inf)),
                       torch.nextafter(t, torch.full_like(t, -math.inf)))

  runs = runs or (fused_reference, fused_cuda)
  bases = [run(sub_args, sub_kwargs) for run in runs]
  found = torch.zeros(len(idx), dtype=torch.bool, device=args[0].device)
  for _ in range(trials):
    nudged = (nudge(sub_args[0]),) + sub_args[1:3] + (
        tensor_map(nudge, sub_args[3]) if weights else sub_args[3],)
    for run, (_, v0, q0) in zip(runs, bases):
      _, v, q = run(nudged, sub_kwargs)
      found |= outside(v, v0) | outside(q, q0).any(-1)
  return found


def f64_disagrees(args, kwargs, idx):
  """Which of the envs ``idx`` of a recorded MLP search launch the plain
  version computes differently in f32 and in f64 (root value or a root q
  past rtol = atol = 1e-3), their inputs alone as a batch of their own:
  f32 rounding alone decides their trees."""
  sub_args, sub_kwargs = sub_launch(args, kwargs, idx)
  _, v32, q32 = fused_reference(sub_args, sub_kwargs)
  _, v64, q64 = fused_reference(tensor_map(torch.Tensor.double, sub_args),
                                sub_kwargs)
  return outside(v32.double(), v64) | outside(q32.double(), q64).any(-1)



def tie_proof(args, kwargs):
  """Phase 21's proof that an env of a recorded MLP search launch is a
  near-tie: an ulp of its inputs moves it (``ulp_sensitive``), or f32
  rounding alone does (``f64_disagrees``)."""
  return lambda idx: (ulp_sensitive(args, kwargs, idx)
                      | f64_disagrees(args, kwargs, idx))

def make_net(device, family="mlp", num_actions=2, **widths):
  """The flagship MLP triplet (bench.py:69-71), the acme categorical family
  (bench.py:72-75) or Stochastic MuZero's five nets (bench.py:80-83) on
  ``device``; ``widths`` replace the towers."""
  from muax_tpu_torch.models import (make_categorical_mlp_networks,
                                     make_mlp_networks,
                                     make_stochastic_mlp_networks)
  if family == "categorical":
    return make_categorical_mlp_networks(num_actions, device=device,
                                         **(widths or CAT_NET))
  if family == "smz":
    return make_stochastic_mlp_networks(num_actions, device=device,
                                        **(widths or SMZ_NET))
  return make_mlp_networks(num_actions, embedding_dim=EMBED,
                           support_size=SUPPORT, device=device, **widths)


def search_counts():
  """Launches of the search kernels by mode: MLP MuZero, MLP Gumbel,
  categorical MuZero, categorical Gumbel, Stochastic MuZero."""
  from muax_tpu_torch.search import fused
  return (fused.launches, fused.gumbel_launches, fused.categorical_launches,
          fused.categorical_gumbel_launches, fused.smz_launches)


def reset_counts():
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.search import fused
  fused.launches = fused.gumbel_launches = 0
  fused.wide_launches = fused.wide_gumbel_launches = 0
  fused.categorical_launches = fused.categorical_gumbel_launches = 0
  fused.smz_launches = fused.smz_wide_launches = 0
  fused_sampler.launches = 0
  fused_learner.launches = fused_learner.categorical_launches = 0
  fused_learner.wide_launches = 0


def search_mode(policy, family):
  """The index of ``search_counts`` that a rollout of this kind moves."""
  if family == "smz":
    return 4
  return (2 if family == "categorical" else 0) + (policy == "gumbel")


def search_against_plain(device, policy, family, num_actions, batch,
                         widths=None, with_invalid=False, max_depth=None,
                         group=None, timed=False):
  """Phases 1-2, 8 and 12: one mode of the search kernel against its plain
  version on the same inputs (seeded weights, roots from random CartPole
  observations, Dirichlet or Gumbel noise from SEED), as compare_search;
  in the Gumbel modes the policy's action must also agree on at least 99 %
  of envs, and no env may take an invalid action. ``group`` fixes the MLP
  modes' lane-group size G; ``timed`` adds the kernel's and the plain
  version's times and the bound."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.search.policies import _mask_invalid
  from muax_tpu_torch.train.inference import make_root_fn

  net = make_net(device, family, num_actions, **(widths or {}))
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, batch)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  weights = fused.extract_search_weights(net, params)
  kwargs = dict(num_simulations=MAIN_SIMS, discount=0.997,
                support_size=getattr(net, "support_size", None),
                invalid_actions=invalid, max_depth=max_depth)
  mode = search_mode(policy, family)
  if policy == "gumbel":
    logits = _mask_invalid(root.prior_logits, invalid).contiguous()
    gumbel = gumbel_noise(gen, (batch, num_actions), device)
    args = (root.embedding.contiguous(), logits, root.value.contiguous(),
            weights)
    root_score, schedule = fused.gumbel_root_inputs(
        logits, gumbel, invalid, max_num_considered_actions=16,
        num_simulations=MAIN_SIMS)

    def launch():
      return fused.fused_gumbel_search(*args, gumbel=gumbel,
                                       max_num_considered_actions=16,
                                       **kwargs)

    def plain():
      return fused.fused_gumbel_search_reference(
          *args, root_score=root_score, schedule=schedule, **kwargs)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits, invalid)
    args = (root.embedding.contiguous(), logits, root.value.contiguous(),
            weights)

    def launch():
      return fused.fused_muzero_search(*args, **kwargs)

    def plain():
      return fused.fused_muzero_search_reference(*args, **kwargs)
  chosen = fused.mlp_search_plan
  if group is not None:
    fused.mlp_search_plan = lambda *a, **kw: chosen(*a, group=group, **kw)
  try:
    before = search_counts()
    out = launch()
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(search_counts(), before))
    if timed:
      ms = time_ms(launch, 5)
  finally:
    fused.mlp_search_plan = chosen
  check(got == tuple(int(i == mode) for i in range(len(got))),
        f"the wrapper launched the {family} {policy} mode once, not {got}")
  ref = plain()
  figures = compare_search(out, ref, MAIN_SIMS, invalid)
  if timed:
    figures["ms"] = ms
    figures["plain_ms"] = time_ms(plain, 1)
    figures["bound_ms"], figures["bound_by"] = search_bound_ms(
        batch, MAIN_SIMS, weights, with_invalid, gumbel=policy == "gumbel",
        peak=PEAK_3XTF32_FLOPS if family == "categorical"
        else PEAK_F32_FLOPS)
  if policy == "gumbel":
    action, _ = fused.gumbel_action(out[0], out[2], gumbel, logits, invalid)
    ref_action, _ = fused.gumbel_action(ref[0], ref[2], gumbel, logits,
                                        invalid)
    same = float((action == ref_action).float().mean())
    check(same >= 0.99, f"{same:.4f} of envs take the plain version's "
          "action (need 0.99)")
    if invalid is not None:
      check(not bool(invalid[torch.arange(batch, device=device),
                             action.long()].any()),
            "no env takes an invalid action")
    figures["same_action"] = same
  return figures


def mlp_search_figures(device, args, kwargs, gumbel):
  """Phases 3 and 9: the MLP search kernel timed on the rollout's last roots
  at MAIN_ENVS and on the first TRAIN_ENVS of them (the training
  iteration's batch), with the plain version's time, the bound, the launch
  plan and the theoretical occupancy: the CUDA runtime's occupancy
  calculator's blocks per SM for the compiled instance, at most the blocks
  the grid gives the busiest SM, in warps (what the card can hold, not
  what a counter saw resident). Keys for TRAIN_ENVS end in _1024."""
  from muax_tpu_torch.search import fused
  plain = (fused.fused_gumbel_search_reference if gumbel
           else fused.fused_muzero_search_reference)
  weights = args[3]
  A, E = args[1].shape[1], args[0].shape[1]
  widths = [2 * SUPPORT + 1] + [w.shape[1] for w, _ in (
      *weights.dyn_hidden, *weights.pred_hidden)]
  n_weights = weights.flat().numel()
  limits = fused.device_limits(device)
  out = {}
  for batch, suffix in ((MAIN_ENVS, ""), (TRAIN_ENVS, f"_{TRAIN_ENVS}")):
    a = tuple(t[:batch].contiguous() for t in args[:3]) + (weights,)
    kw = dict(kwargs)
    if gumbel:
      kw["root_score"] = kwargs["root_score"][:batch].contiguous()
      kw["schedule"] = kwargs["schedule"][:batch].contiguous()
    out["search_ms" + suffix] = time_ms(
        lambda: fused._fused_search_cuda(*a, **kw), 10)
    out["plain_search_ms" + suffix] = time_ms(lambda: plain(*a, **kw), 1)
    out["bound_ms" + suffix], out["bound_by" + suffix] = search_bound_ms(
        batch, MAIN_SIMS, weights, False, gumbel=gumbel)
    plan = fused.mlp_search_plan(batch, A, E, MAIN_SIMS, n_weights, widths,
                                 gumbel, limits)
    floats = fused.mlp_env_floats(A, E, MAIN_SIMS,
                                  fused.mlp_act_width(A, E, widths), gumbel,
                                  plan.smem_emb)
    blocks = fused.mlp_blocks_per_sm(plan, n_weights, floats, gumbel, device)
    busiest = min(blocks, -(-plan.grid // limits.sms))
    out["plan" + suffix] = dict(
        plan._asdict(), runtime_blocks_per_sm=blocks,
        theoretical_warps_per_sm=busiest * plan.envs_per_block * plan.group
        // 32)
  return out


def drive_main_path(device, policy="muzero", family="mlp"):
  """Phase 3 (MuZero) or 9 (Gumbel) on the MLP triplet, 13 on the
  categorical family, 17 on Stochastic MuZero: make_rollout_fn at the
  path's size. Every rollout launches the kernel in its mode once per step
  and the other modes never. Returns the launch count of the run, its
  figures and the kernel's inputs on its last state."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train import make_rollout_fn
  from muax_tpu_torch.train.inference import make_root_fn, make_smz_fns

  categorical, smz = family == "categorical", family == "smz"
  envs = CAT_ENVS if categorical else SMZ_ENVS if smz else MAIN_ENVS
  sims = SMZ_SIMS if smz else MAIN_SIMS
  warmup, timed = (1, 2) if categorical or smz else (WARMUP_ROLLOUTS,
                                                     TIMED_ROLLOUTS)
  env = AutoResetWrapper(CartPole())
  net = make_net(device, family)
  params = net.init_params(env.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=sims),
      train=TrainConfig(num_envs=envs, collect_steps=MAIN_STEPS))
  rollout = make_rollout_fn(net, env, config, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = env.reset(gen, envs)
  gumbel = policy == "gumbel"
  mode = search_mode(policy, family)
  want = tuple(MAIN_STEPS if i == mode else 0
               for i in range(len(search_counts())))

  def one(carry):
    before = search_counts()
    carry, seg, prio, metrics = rollout(params, carry, gen,
                                        params.temperature)
    got = tuple(a - b for a, b in zip(search_counts(), before))
    check(got == want, f"search launches by mode {got} in a {family} "
          f"{policy} rollout of {MAIN_STEPS} steps, not {want}")
    return carry, seg, prio, metrics

  reset_counts()
  finished = 0
  for _ in range(warmup):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(timed):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  end.record()
  end.synchronize()
  launches = search_counts()[mode]
  rollout_ms = start.elapsed_time(end) / timed

  B, T = envs, MAIN_STEPS
  shapes = {"obs": (B, T, 4), "action": (B, T), "reward": (B, T),
            "done": (B, T), "rn": (B, T), "value": (B, T),
            "pi": (B, T, 2), "weight": (B,), "mask": (B, T)}
  for name, shape in shapes.items():
    got = tuple(getattr(seg, name).shape)
    check(got == shape, f"segment {name} has shape {got}, not {shape}")
    if name not in ("action", "done"):
      check(bool(torch.isfinite(getattr(seg, name)).all()),
            f"segment {name} is finite")
  check(tuple(prio.shape) == (B, T) and bool(torch.isfinite(prio).all()),
        "priorities [B, T] are finite")
  check(bool(((seg.action >= 0) & (seg.action < 2)).all()), "actions valid")
  check(torch.allclose(seg.pi.sum(-1), torch.ones(B, T, device=device),
                       atol=1e-5), "pi rows sum to 1")
  check(finished > 0, "at least one episode finished")

  with torch.no_grad():
    root = (make_smz_fns(net, config.train.discount)[0] if smz
            else make_root_fn(net))(params, carry.obs)
  kwargs = dict(num_simulations=sims, discount=config.train.discount,
                support_size=getattr(net, "support_size", None),
                invalid_actions=None, max_depth=None)
  if smz:
    logits = fused.noised_root_logits(gen, root.prior_logits)
    weights = fused.extract_smz_fused_weights(net, params)
  elif gumbel:
    logits = root.prior_logits.contiguous()
    kwargs["root_score"], kwargs["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel_noise(gen, logits.shape, device), None,
        max_num_considered_actions=config.search.max_num_considered_actions,
        num_simulations=MAIN_SIMS)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits)
  if not smz:
    weights = fused.extract_search_weights(net, params)
  search_in = ((root.embedding.contiguous(), logits, root.value.contiguous(),
                weights), kwargs)
  figures = {"rollout_ms": rollout_ms,
             "env_steps_per_s": B * T / (rollout_ms / 1e3),
             "episodes_finished": finished, "launches": launches}
  return launches, figures, search_in


def training_config(policy="muzero", family="mlp"):
  """bench.py's training_regime (bench.py:463-467, run_config), or with
  ``policy="gumbel"`` its gumbel_training (bench.py:306-309), or with
  ``family="categorical"`` its categorical_training (bench.py:351-354), or
  with ``family="smz"`` its smz_training (bench.py:367-373)."""
  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  categorical = family == "categorical"
  if family == "smz":
    return MuZeroConfig(
        search=SearchConfig(policy="stochastic", num_simulations=SMZ_SIMS),
        replay=ReplayConfig(capacity=TRAIN_CAPACITY, min_fill=64),
        train=TrainConfig(
            num_envs=SMZ_ENVS, collect_steps=MAIN_STEPS,
            batch_size=SMZ_BATCH, updates_per_iteration=SMZ_UPDATES,
            unroll_steps=TRAIN_UNROLL, n_bootstrap=TRAIN_NSTEP,
            presample_updates=SMZ_PRESAMPLE))
  return MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      replay=ReplayConfig(capacity=TRAIN_CAPACITY, min_fill=64),
      train=TrainConfig(
          num_envs=CAT_TRAIN_ENVS if categorical else TRAIN_ENVS,
          collect_steps=MAIN_STEPS,
          batch_size=CAT_BATCH if categorical else TRAIN_BATCH,
          updates_per_iteration=CAT_UPDATES if categorical
          else TRAIN_UPDATES,
          unroll_steps=TRAIN_UNROLL, n_bootstrap=TRAIN_NSTEP,
          presample_updates=TRAIN_PRESAMPLE))


def training_setup(device, policy="muzero", family="mlp"):
  """The training regime built from the port's entry points, with random
  weights from SEED: networks, rollout, learner, ring, env carry."""
  import math
  from types import SimpleNamespace

  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import muzero_optimizer
  from muax_tpu_torch.replay import replay_init
  from muax_tpu_torch.train import (TrainState, make_multi_update_fn,
                                    make_rollout_fn)

  config = training_config(policy, family)
  tcfg = config.train
  env = AutoResetWrapper(CartPole())
  net = make_net(device, family)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  optimizer = muzero_optimizer()
  gen = torch.Generator(device=device).manual_seed(SEED)
  return SimpleNamespace(
      config=config, env=env, net=net, gen=gen, family=family,
      envs=tcfg.num_envs, batch=tcfg.batch_size,
      updates=tcfg.updates_per_iteration,
      group=math.gcd(tcfg.updates_per_iteration, tcfg.presample_updates),
      rollout=make_rollout_fn(net, env, config, device=device),
      multi_update=make_multi_update_fn(net, optimizer, config),
      ts=TrainState(params, optimizer.init(params), 0),
      rs=replay_init(TRAIN_CAPACITY, MAIN_STEPS, (4,), 2, device=device),
      carry=env.reset(gen, tcfg.num_envs))


def loss_kwargs(config):
  return dict(l2_coef=config.train.l2_coef,
              gradient_scale=config.train.gradient_scale,
              priority_alpha=config.replay.priority_alpha)


def compare_raw(raw, ref, lay):
  """Sampler kernel against plain: the start agrees on at least 99.99 % of
  windows (logf and torch.log may differ by an ulp at a near-tie), and
  where it agrees every raw row is exactly equal."""
  same = raw[lay.start] == ref[lay.start]
  share = float(same.float().mean())
  check(share >= 0.9999, f"{share:.6f} of windows with the same start "
        "(need 0.9999)")
  err = float((raw[:, same] - ref[:, same]).abs().max())
  check(err == 0.0, f"raw rows differ by {err} where the start agrees")
  return {"same_start": share, "max_abs_err": err}


def fill_ring(t):
  """Two rollouts of the port fill the ring (2048 segments; 1024 of the
  categorical regime's 512 envs); returns the last segments and
  priorities."""
  from muax_tpu_torch.replay import replay_add

  for _ in range(2):
    t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                      t.ts.params.temperature)
    replay_add(t.rs, seg, prio, step=t.ts.step)
  check(t.rs.size == min(TRAIN_CAPACITY, 2 * t.envs),
        "two rollouts fill the ring")
  return seg, prio


def sampler_launch_against_plain(device, gen, state, W):
  """One sampler launch of W windows drawn from the ring ``state`` with
  ``gen``, as the learner draws them, against the plain version on the same
  draws (compare_raw). Returns the figures and (draws, gumbel, raw,
  layout)."""
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.replay.buffer import gumbel_noise

  seg_idx = fused_sampler.draw_segments(state, gen, W)
  gumbel = gumbel_noise(gen, (MAIN_STEPS, W), device)
  before = fused_sampler.launches
  raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel,
                                              TRAIN_UNROLL)
  torch.cuda.synchronize()
  check(fused_sampler.launches == before + 1, "the sampler launched")
  ref, _ = fused_sampler.fused_sample_group_reference(state, seg_idx,
                                                      gumbel, TRAIN_UNROLL)
  return compare_raw(raw, ref, lay), (seg_idx, gumbel, raw, lay)


def sampler_against_plain(device, t):
  """Phase 4: fill the ring with two rollouts of the port (2048 segments),
  draw W = 16 x 4096 windows as the learner does, kernel against plain;
  then W = 1000 from a half-filled ring of 64 segments with dones."""
  from muax_tpu_torch.replay import replay_add, replay_init
  from muax_tpu_torch.types import Transition

  seg, prio = fill_ring(t)

  def one(state, W):
    return sampler_launch_against_plain(device, t.gen, state, W)

  main, inputs = one(t.rs, TRAIN_GROUP * TRAIN_BATCH)
  edge_ring = replay_init(64, MAIN_STEPS, (4,), 2, device=device)
  replay_add(edge_ring, Transition(**{
      k: v[:32] for k, v in vars(seg).items()}), prio[:32])
  check(bool(edge_ring.done[:32].any()), "the edge ring holds dones")
  edge, _ = one(edge_ring, 1000)
  return main, edge, inputs


def grads_close(grads, ref, rtol, atol):
  """Largest |kernel - plain| and the largest share of the tolerance
  atol + rtol |plain| that an element uses; fails above 1."""
  err = (grads - ref).abs()
  used = float((err / (atol + rtol * ref.abs())).max())
  check(used <= 1.0, f"gradients differ by up to {float(err.max()):.3g} "
        f"({used:.3g} of the tolerance rtol {rtol} / atol {atol})")
  return float(err.max()), used


def metrics_close(metrics, ref, priorities=True):
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    a, b = float(getattr(metrics, name)), float(getattr(ref, name))
    check(abs(a - b) <= 1e-5 * abs(b), f"{name}: {a} against plain {b}")
  # Priorities are |v0 - rn0|^0.5, and v0 is h^-1 of a 41-bin expectation,
  # which amplifies f32 rounding: |v0| ~ 10 carries errors of ~1e-4.
  if priorities:
    check(torch.allclose(metrics.priorities, ref.priorities, rtol=1e-4,
                         atol=1e-4), "priorities agree")


def priorities_against_f64(net, params, raw_b, coef, lay, kw, metrics, ref):
  """The learner's priorities where the net's values are large, as a
  trained net's are (|rn0| up to 50 on CartPole after phase 32's 640
  updates): f32 rounding of v0, h^-1 of a 41-bin expectation, then
  reaches 7e-4, and the square root magnifies it where v0 is near rn0, so
  that the plain f32 version itself leaves rtol = atol = 1e-4 of an f64
  computation. So |v0 - rn0| (priorities ** (1 / alpha)) of the kernel is
  held against the plain version run in f64 on the same inputs: its
  largest error at most twice the plain f32 version's own."""
  import copy

  from muax_tpu_torch.models import fused_learner
  _, exact = fused_learner.fused_muzero_grad_raw_reference(
      copy.deepcopy(params).double(), raw_b.double(), coef.double(), lay,
      net, **kw)
  inv = 1.0 / kw["priority_alpha"]
  gap = exact.priorities ** inv
  err = float((metrics.priorities.double() ** inv - gap).abs().max())
  plain = float((ref.priorities.double() ** inv - gap).abs().max())
  check(err <= 2.0 * plain + 1e-6, f"|v0 - rn0| off the f64 plain version "
        f"by {err:.3g}, more than twice the plain f32 version's {plain:.3g}")
  return {"v0_gap_err_f64": err, "plain_f32_v0_gap_err_f64": plain}


def seeded_batch(device, A, B, K, rn_scale, reward_scale=1.0):
  """B windows of K steps with masks, from SEED + 1."""
  from muax_tpu_torch.types import Transition

  gen = torch.Generator(device=device).manual_seed(SEED + 1)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=device)
  return Transition(
      obs=torch.randn((B, K, 4), generator=gen, device=device),
      action=torch.randint(0, A, (B, K), generator=gen, device=device),
      reward=torch.randn((B, K), generator=gen, device=device) * reward_scale,
      done=torch.zeros((B, K), dtype=torch.bool, device=device),
      rn=torch.randn((B, K), generator=gen, device=device) * rn_scale,
      value=torch.zeros((B, K), device=device),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen,
                                   device=device), -1),
      weight=torch.rand((B,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())


# The CartPole notebook's towers (muax_tpu_torch/examples/parity_cartpole.py:
# embedding 10, support 20, no representation hidden layer, (64, 64, 16)),
# at its batch and unroll; their arena lies in the device scratch.
NOTEBOOK_NET = dict(embedding_dim=10, support_size=20, repr_layers=(),
                    pred_layers=(64, 64, 16), dyn_layers=(64, 64, 16))
NOTEBOOK_BATCH, NOTEBOOK_K = 256, 11


def learner_batch(raw, lay, B):
  """The first ``B`` of a sampler launch's windows and their loss
  coefficients, as the learner's raw path takes them."""
  raw_b = raw[:, :B]
  w_raw = raw_b[lay.weight]
  coef = (w_raw / torch.clamp(w_raw.mean(), min=1e-9) / raw_b[lay.denom]
          / B).contiguous()
  return raw_b, coef


def learner_launch_against_plain(device, kw, net, params, raw_b, coef, lay,
                                 trained=False):
  """Two MLP learner launches on the same windows, the scratch's memory
  NaN before each, bit-identical to each other and against autograd over
  muzero_loss (gradients rtol 2e-4 / atol 1e-6, metrics_close); with
  ``trained``, the priorities as priorities_against_f64."""
  from muax_tpu_torch.models import fused_learner

  def poison(lw, B, K):
    # The caching allocator hands a freed block of this size back first.
    plan = fused_learner.mlp_learner_plan(B, K, lw,
                                          fused_learner.device_limits(device))
    torch.full((plan.scratch_floats,), float("nan"), device=device)

  lw = fused_learner.extract_learner_weights(net, params)
  before = fused_learner.launches
  poison(lw, raw_b.shape[1], lay.K)
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw_b, coef, lay, net, lw, **kw)
  poison(lw, raw_b.shape[1], lay.K)
  again, _ = fused_learner.fused_muzero_grad_raw(params, raw_b, coef, lay,
                                                 net, lw, **kw)
  torch.cuda.synchronize()
  check(fused_learner.launches == before + 2, "the learner launched")
  check(torch.equal(grads, again), "a repeated launch gives bit-identical "
        "gradients")
  ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
      params, raw_b, coef, lay, net, **kw)
  err, used = grads_close(grads, ref_grads, 2e-4, 1e-6)
  metrics_close(metrics, ref_metrics, priorities=not trained)
  figures = {"max_abs_err": err, "tolerance_used": used}
  if trained:
    figures.update(priorities_against_f64(net, params, raw_b, coef, lay, kw,
                                          metrics, ref_metrics))
  return figures


def learner_against_plain(device, t, raw, lay):
  """Phase 5: the learner kernel against autograd over muzero_loss on the
  first 4096 of phase 4's windows (the flagship triplet), on a seeded
  batch of 1000 windows with masks (A = 4, towers (16, 16), support 10),
  on the notebook towers (NOTEBOOK_NET) at K = 11 and on wide towers
  (128,), whose prediction tower's weight gradients wait for the last
  pass; two launches on the same inputs give bit-identical gradients. The
  scratch's memory holds NaN before each launch, so that a row of it the
  kernel leaves unwritten shows in the gradients."""
  from muax_tpu_torch.models import fused_learner, make_mlp_networks

  kw = loss_kwargs(t.config)

  def one(net, params, raw_b, coef, lay):
    return learner_launch_against_plain(device, kw, net, params, raw_b, coef,
                                        lay)

  main = one(t.net, t.ts.params, *learner_batch(raw, lay, TRAIN_BATCH), lay)

  def seeded(net, B, K):
    params = net.init_params((4,), torch.Generator().manual_seed(SEED + 1))
    batch = seeded_batch(device, net.num_actions, B, K, 5.0)
    return one(net, params, *fused_learner.raw_from_batch(batch, K))

  edge = seeded(make_mlp_networks(4, embedding_dim=EMBED, support_size=10,
                                  pred_layers=(16, 16), dyn_layers=(16, 16),
                                  device=device), 1000, TRAIN_UNROLL)
  notebook = seeded(make_mlp_networks(2, device=device, **NOTEBOOK_NET),
                    NOTEBOOK_BATCH, NOTEBOOK_K)
  wide = seeded(make_mlp_networks(2, embedding_dim=EMBED, support_size=SUPPORT,
                                  pred_layers=(128,), dyn_layers=(128,),
                                  device=device), 300, TRAIN_UNROLL)
  return main, edge, notebook, wide


def categorical_learner_against_plain(device, t, raw, lay):
  """Phase 14: the categorical learner kernel against autograd over the
  categorical muzero_loss on the first 1024 of W sampled windows of a ring
  of the family's rollouts (bench widths), and on a seeded batch of 300
  windows with masks (A = 3, towers (48, 32), 21 bins); gradients rtol 5e-4
  / atol 1e-6, loss metrics rtol 1e-5, priorities rtol 1e-4
  (tests/test_fused_learner.py:156-162); two launches on the same inputs
  give bit-identical gradients."""
  from muax_tpu_torch.models import fused_learner

  kw = loss_kwargs(t.config)

  def one(net, params, raw_b, coef, lay):
    spec = fused_learner.extract_categorical_learner_spec(net, params)
    before = fused_learner.categorical_launches
    grads, metrics = fused_learner.fused_muzero_grad_raw(
        params, raw_b, coef, lay, net, spec, **kw)
    again, _ = fused_learner.fused_muzero_grad_raw(params, raw_b, coef, lay,
                                                   net, spec, **kw)
    torch.cuda.synchronize()
    check(fused_learner.categorical_launches == before + 2,
          "the categorical learner launched")
    check(torch.equal(grads, again), "a repeated launch gives bit-identical "
          "gradients")
    ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
        params, raw_b, coef, lay, net, **kw)
    err, used = grads_close(grads, ref_grads, 5e-4, 1e-6)
    metrics_close(metrics, ref_metrics)
    return {"max_abs_err": err, "tolerance_used": used}

  main = one(t.net, t.ts.params, *learner_batch(raw, lay, t.batch), lay)

  A, Be, K = 3, 300, TRAIN_UNROLL
  net = make_net(device, "categorical", A, **CAT_EDGE_NET)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED + 1))
  batch = seeded_batch(device, A, Be, K, 8.0, reward_scale=3.0)
  edge = one(net, params, *fused_learner.raw_from_batch(batch, K))
  return main, edge


def sampler_bound_ms(lay, W, L, obs_bytes=4):
  """Least time for one sampler launch: per window its index (8 bytes),
  num_starts Gumbels and priorities, the start observation (every step's
  with per_step_obs; ``obs_bytes`` an element: 4 for f32 rings, 1 for
  uint8), K actions, rewards, returns and dones (one byte), K x A policy
  entries and the target step read once, and the raw rows written once;
  against that the log, add and compare of each valid start."""
  num_starts = L - lay.K + 1
  per_window = (8 + 8 * num_starts + obs_bytes * lay.obs_rows + 13 * lay.K
                + 4 * lay.K * lay.A + 4 + 4 * lay.rows)
  t_bytes = W * per_window / PEAK_BYTES_PER_S * 1e3
  t_ops = 3.0 * W * num_starts / PEAK_F32_FLOPS * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def learner_bound_ms(net, lay, B, n_weights, peak=PEAK_F32_FLOPS):
  """Least time for one learner launch. Operations: per window the
  forward's multiply-adds (representation, then K x prediction and
  dynamics) and twice as many for the backward, over ``peak``; bytes: the
  raw rows, coef and weights read once, gradients, metrics and l2 written
  once."""
  E, A = net.embedding_dim, net.num_actions
  if hasattr(net, "num_bins"):
    bins = net.num_bins
    repr_h = pred_h = dyn_h = net.layer_sizes
  else:
    bins = net.full_support
    repr_h, pred_h, dyn_h = net.repr_layers, net.pred_layers, net.dyn_layers

  def tower(in_dim, hidden, heads):
    macs = 0
    for h in hidden:
      macs += in_dim * h
      in_dim = h
    return macs + in_dim * sum(heads)

  fwd = (tower(lay.O, repr_h, (E,))
         + lay.K * (tower(E, pred_h, (bins, A))
                    + tower(E + A, dyn_h, (bins, E))))
  t_ops = 2.0 * 3.0 * fwd * B / peak * 1e3
  floats = lay.rows * B + B + 2 * n_weights + 4 * B + 1
  t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mlp_line(figures, groups, ptxas, gumbel):
  """The MLP search's extra keys in the kernel line: the plan's choice at
  MAIN_ENVS and TRAIN_ENVS, the times at TRAIN_ENVS, and every instance with
  its registers and its largest error against the plain version."""
  from muax_tpu_torch.search import fused
  t = f"_{TRAIN_ENVS}"
  return {
      "plan": figures["plan"], "plan" + t: figures["plan" + t],
      "ms" + t: figures["search_ms" + t],
      "plain_ms" + t: figures["plain_search_ms" + t],
      "bound_ms" + t: figures["bound_ms" + t],
      "instances": {
          f"fused_search_kernel<{gumbel}><{g}><true>": dict(
              ptxas.get(
                  f"fused_search:fused_search_kernel<{gumbel}><{g}><true>",
                  {}), max_abs_err=groups[f"G={g}"]["max_abs_err"])
          for g in fused.MLP_GROUPS}}


def ptxas_figures(logs):
  """Registers and spill bytes of every kernel, from nvcc's -Xptxas -v
  output by source; kernel templates are labelled by their arguments."""
  figures = {}
  for source, log in logs.items():
    entry = None
    for line in log.splitlines():
      found = re.search(r"Compiling entry function '([^']+)'", line)
      if found:
        sym = found.group(1)
        name = re.search(r"([a-z_]+_kernel)(I.*?EE)?", sym)
        args = re.findall(r"L([bi])(\d+)E", name.group(2) or "")
        label = name.group(1) + "".join(
            f"<{'true' if v == '1' else 'false'}>" if k == "b" else f"<{v}>"
            for k, v in args)
        entry = figures.setdefault(f"{source}:{label}", {})
      elif entry is not None and "spill stores" in line:
        stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        entry.update(spill_stores=int(stores), spill_loads=int(loads))
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame:
          entry["stack_frame"] = int(frame.group(1))
      elif entry is not None and "registers" in line:
        entry["registers"] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
  return figures


def kernel_device_ms(fn, reps):
  """Device time per call of each kernel that ``fn`` launches
  (torch.profiler), or None where the profiler records no device time."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  times = {e.key: e.self_device_time_total / 1e3 / reps
           for e in prof.key_averages() if e.self_device_time_total > 0}
  return times or None


def profile_iteration(one, host_ops=True):
  """One more training iteration under torch.profiler: device time by
  kernel (self CUDA time summed over launches), the device's busy time and
  the count of kernel launches. Profiling slows the host, so the busy time
  is set against the unprofiled iteration time by the caller. Without
  ``host_ops`` only the device's activity is recorded. The device events
  are read from the profiler's raw results, not through ``key_averages()``,
  whose event tree takes tens of seconds to build for the hundred thousand
  launches of a generic-engine search."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  activities = [ProfilerActivity.CUDA]
  if host_ops:
    activities.append(ProfilerActivity.CPU)
  with profile(activities=activities) as prof:
    one()
    torch.cuda.synchronize()
  by_name = {}
  for e in prof.profiler.kineto_results.events():
    if e.device_type() == DeviceType.CUDA:
      us, count = by_name.get(e.name(), (0.0, 0))
      by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
  busy_us = sum(us for us, _ in by_name.values())
  if busy_us <= 0:
    return {"device_busy_ms": None, "kernel_launches": None, "top": None}
  top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
  return {"device_busy_ms": busy_us / 1e3,
          "kernel_launches": sum(c for _, c in by_name.values()),
          "top": [[name[:60], us / 1e3, count]
                  for name, (us, count) in top]}


def profile_window(fn, host_ops=False):
  """``fn``'s wall time with CUDA events and, over one more call under
  ``torch.profiler`` (device activity only, unless ``host_ops``), its
  kernel launches and the device's idle share."""
  window_ms = time_ms(fn, 1)
  prof = profile_iteration(fn, host_ops=host_ops)
  busy = prof["device_busy_ms"]
  prof["window_ms"] = window_ms
  prof["idle_share"] = None if busy is None else 1.0 - busy / window_ms
  return prof


def drive_training(device, t, warmup=WARMUP_ITERATIONS,
                   timed=TIMED_ITERATIONS, window_updates=None):
  """Phase 6 (MuZero), 10 (Gumbel), 15 (categorical) or 19 (Stochastic
  MuZero): the training iteration, rollout -> replay_add ->
  make_multi_update_fn, ``warmup`` and ``timed`` iterations. Every
  iteration launches exactly 20 searches in the config's mode, updates /
  group samplers and one learner per update in the family's mode (none for
  Stochastic MuZero, whose hybrid feed runs autograd), and no search or
  learner in any other mode. The profile covers one more iteration, or
  with ``window_updates`` a rollout and, apart, that many updates (an
  iteration of Stochastic MuZero makes over a million launches, which the
  profiler takes minutes to record): the iteration's idle share is then
  the two windows' idle shares weighted by the rollout's and the updates'
  time in the timed iterations."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler, replay_add

  mode = search_mode(t.config.search.policy, t.family)
  smz = t.family == "smz"

  def read():
    searches = search_counts()
    learners = (fused_learner.launches, fused_learner.categorical_launches)
    mine = 0 if smz else learners[t.family == "categorical"]
    return (searches[mode], fused_sampler.launches, mine,
            sum(searches) - searches[mode] + sum(learners) - mine)

  # Launches (search, sampler, learner, any other mode) per iteration.
  expected = (MAIN_STEPS, t.updates // t.group, 0 if smz else t.updates, 0)
  marks = []  # per timed iteration: events before, between and after

  def one(timed=False):
    before = read()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                      t.ts.params.temperature)
    replay_add(t.rs, seg, prio, step=t.ts.step)
    events[1].record()
    t.ts, t.rs, metrics = t.multi_update(t.ts, t.rs, t.gen)
    events[2].record()
    if timed:
      marks.append(events)
    got = tuple(a - b for a, b in zip(read(), before))
    check(got == expected, f"launches (search, sampler, learner, other "
          f"modes) {got} in one iteration, not {expected}")
    return metrics

  reset_counts()
  runs = [one() for _ in range(warmup)]
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  runs += [one(timed=True) for _ in range(timed)]
  end.record()
  end.synchronize()
  launches = list(read()[:3])
  iteration_ms = start.elapsed_time(end) / timed
  rollout_ms = sum(a.elapsed_time(b) for a, b, _ in marks) / timed
  learner_ms = sum(b.elapsed_time(c) for _, b, c in marks) / timed
  if window_updates is None:
    profile = profile_iteration(one)
  else:
    def rollout():
      t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                        t.ts.params.temperature)
      replay_add(t.rs, seg, prio, step=t.ts.step)

    def updates():
      t.ts, t.rs, _ = t.multi_update(t.ts, t.rs, t.gen, window_updates)

    profile = {"rollout": profile_window(rollout, host_ops=True),
               "updates": profile_window(updates, host_ops=True)}
    profile["updates"]["window"] = (f"{window_updates} of the {t.updates} "
                                    "updates")
    if None not in (profile["rollout"]["idle_share"],
                    profile["updates"]["idle_share"]):
      profile["device_idle_share"] = (
          profile["rollout"]["idle_share"] * rollout_ms
          + profile["updates"]["idle_share"] * learner_ms) / iteration_ms
  for metrics in runs:
    check(metrics["updates_done"] == t.updates,
          f"{metrics['updates_done']} updates, not {t.updates}")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"metric {k} = {float(v)} is finite")
  figures = {
      "iteration_ms": iteration_ms,
      "env_steps_per_s": t.envs * MAIN_STEPS / (iteration_ms / 1e3),
      "learner_windows_per_s": t.updates * t.batch / (iteration_ms / 1e3),
      "rollout_ms": rollout_ms,
      "learner_ms": learner_ms,
      "launches": dict(zip(("search", "sampler", "learner"), launches)),
      "loss": float(runs[-1]["loss"]),
      "profile": profile,
  }
  if profile.get("device_busy_ms") is not None:
    profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / (
        iteration_ms)
  return launches, figures


def drive_fit(device, root, family="mlp"):
  """Phase 7 (the triplet) or 20 (Stochastic MuZero): fit through its
  normal entry, 3 iterations of the family's training regime with
  eval_every=2 and checkpoint_every=2, into a temporary directory under
  build/; for Stochastic MuZero also a resume from the iteration-2
  checkpoint that runs the third iteration again."""
  import tempfile

  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.train.fit import fit

  smz = family == "smz"
  config = training_config(family=family)
  tcfg = config.train
  group = math.gcd(tcfg.updates_per_iteration, tcfg.presample_updates)
  net = make_net(device, family)
  mode = search_mode(config.search.policy, family)
  lines = []
  reset_counts()

  def counts():
    return [search_counts()[mode], fused_sampler.launches,
            fused_learner.launches + fused_learner.categorical_launches]

  os.makedirs(os.path.join(root, "build"), exist_ok=True)
  t0 = time.perf_counter()
  resumed = None
  with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
    state, results = fit(CartPole(), net, config, num_iterations=3,
                         seed=SEED, eval_every=2, log_every=1,
                         checkpoint_every=2, model_dir=d,
                         log_fn=lines.append)
    check(results["model_path"] is not None
          and os.path.exists(results["model_path"]), "best model written")
    check(os.path.exists(os.path.join(d, "ckpt_latest.pkl")),
          "ckpt_latest.pkl written")
    launches = counts()
    if smz:
      state_b, results_b = fit(
          CartPole(), net, config, num_iterations=3, seed=SEED,
          eval_every=2, log_every=1, model_dir=os.path.join(d, "resumed"),
          resume_from=os.path.join(d, "ckpt_it000002.pkl"),
          log_fn=lines.append)
      check(state_b.step == state.step, f"the resumed run reached step "
            f"{state_b.step}, the uninterrupted one {state.step}")
      check([row["iteration"] for row in results_b["history"]] == [1, 2, 3],
            "the resumed run logged iterations 1-3")
      for k, v in results_b["history"][-1].items():
        check(math.isfinite(v), f"resumed fit metric {k} = {v} is finite")
      resumed = {"step": state_b.step,
                 "loss": results_b["history"][-1]["loss"]}
  seconds = time.perf_counter() - t0
  updates = tcfg.updates_per_iteration
  check(launches[1] == 3 * updates // group
        and launches[2] == (0 if smz else 3 * updates)
        and launches[0] >= 4 * MAIN_STEPS,
        f"fit launched (search, sampler, learner) {launches}")
  check(len(results["history"]) == 3, "three logged iterations")
  for row in results["history"]:
    for k, v in row.items():
      check(math.isfinite(v), f"fit metric {k} = {v} is finite")
  last = results["history"][-1]
  return {"seconds": seconds, "status": lines[0],
          "launches": dict(zip(("search", "sampler", "learner"), launches)),
          "test_G": last["test_G"] if "test_G" in last else None,
          "loss": last["loss"], "best_reward": results["best_reward"],
          "resumed": resumed}


def generic_engine(device):
  """Phase 11: the generic engine (``search.fused=False``) on the card, one
  policy step of ``make_policy_fn`` for each policy at 1024 envs x 64
  simulations, timed, with no kernel launch; then the generic policy's
  visits against the kernel's on the same roots (no Dirichlet noise; for
  Gumbel the same noise): within 2 visits on at least 99 % of envs (PUCT's
  random tie-break and the network's own matmul against the kernel's FMAs
  may move a visit)."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused, policies
  from muax_tpu_torch.train import make_policy_fn
  from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn

  B, discount = TRAIN_ENVS, 0.997
  net = make_mlp_networks(2, embedding_dim=EMBED, support_size=SUPPORT,
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, B)
  weights = fused.extract_fused_weights(net, params)
  recurrent_fn = make_recurrent_fn(net, discount)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  emb, value = root.embedding.contiguous(), root.value.contiguous()
  figures = {}
  for policy in ("muzero", "gumbel"):
    config = MuZeroConfig(search=SearchConfig(
        policy=policy, num_simulations=MAIN_SIMS, fused=False))
    policy_fn = make_policy_fn(net, config, discount, device=device)
    outs = []
    before = (fused.launches, fused.gumbel_launches)
    step_ms = time_ms(lambda: outs.append(policy_fn(params, gen, obs, 1.0)),
                      2)
    check((fused.launches, fused.gumbel_launches) == before,
          f"the generic {policy} policy launched no search kernel")
    action, pi, root_value = outs[-1]
    check(tuple(action.shape) == (B,) and bool(
        ((action >= 0) & (action < 2)).all()), "generic actions valid")
    check(torch.allclose(pi.sum(-1), torch.ones(B, device=device),
                         atol=1e-5), "generic pi rows sum to 1")
    check(bool(torch.isfinite(root_value).all()), "generic values finite")

    if policy == "muzero":
      out = policies.muzero_policy(params, gen, root, recurrent_fn,
                                   MAIN_SIMS, dirichlet_fraction=0.0)
      kernel = fused.fused_muzero_search(
          emb, fused.noised_root_logits(gen, root.prior_logits,
                                        dirichlet_fraction=0.0),
          value, weights, num_simulations=MAIN_SIMS, support_size=SUPPORT,
          discount=discount)
    else:
      g = gumbel_noise(gen, root.prior_logits.shape, device)
      out = policies.gumbel_muzero_policy(params, gen, root, recurrent_fn,
                                          MAIN_SIMS, gumbel=g)
      kernel = fused.fused_gumbel_search(
          emb, root.prior_logits.contiguous(), value, weights, gumbel=g,
          max_num_considered_actions=16, num_simulations=MAIN_SIMS,
          support_size=SUPPORT, discount=discount)
    visits = out.search_tree.summary().visit_counts
    check(bool((visits.sum(-1) == MAIN_SIMS).all()),
          "generic visits sum to num_simulations")
    dv = (visits - kernel[0]).abs().amax(-1)
    share = float((dv <= 2).float().mean())
    check(share >= 0.99, f"{share:.4f} of envs within 2 visits of the "
          f"{policy} kernel (need 0.99)")
    figures[policy] = {"step_ms": step_ms, "within_2_visits": share,
                       "exact_visits": float((dv == 0).float().mean())}
  return figures


def smz_macs(weights):
  """Multiply-adds of one expansion of the Stochastic MuZero search, under
  a decision parent (the decision tower) and under a chance parent (the
  chance and prediction towers)."""
  def macs(linears):
    return sum(w.shape[0] * w.shape[1] for w, _ in linears)
  decision = macs(weights.dec_layers) + macs(
      (weights.dec_state, weights.dec_chance, weights.dec_value))
  chance = macs(weights.ch_layers + weights.pred_layers) + macs(
      (weights.ch_state, weights.ch_reward, weights.pred_policy,
       weights.pred_value))
  return decision, chance


def smz_bound_ms(args, kwargs, tensor_cores=False):
  """Least time for one Stochastic MuZero search launch on these inputs:
  the larger of its operations over the f32 peak (with ``tensor_cores``,
  the 3xTF32 peak, and the f32 figure as ``bound_f32_fma_ms``) and its
  bytes over the memory rate. Operations are the branched towers'
  multiply-adds of the expansions this run makes (the plain version, on
  the same inputs, counts those under a chance parent); bytes are each
  input read once (roots, invalid mask, weights) and each output written
  once."""
  from muax_tpu_torch.search import fused

  emb, logits, _, weights = args
  B, A = logits.shape
  sims = kwargs["num_simulations"]
  chance = int(fused._plain_smz_search(
      *args, pb_c_init=1.25, pb_c_base=19652.0, **kwargs)[3].sum())
  dec_macs, ch_macs = smz_macs(weights)
  flops = 2.0 * (dec_macs * (B * sims - chance) + ch_macs * chance)
  floats = B * (emb.shape[1] + A + 1) + weights.flat().numel()
  floats += B * A * (kwargs["invalid_actions"] is not None)
  floats += B * (2 * A + 1)
  t_f32 = flops / PEAK_F32_FLOPS * 1e3
  t_ops = flops / PEAK_3XTF32_FLOPS * 1e3 if tensor_cores else t_f32
  t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
  extra = {"bound_f32_fma_ms": max(t_f32, t_bytes)} if tensor_cores else {}
  return {"bound_ms": max(t_ops, t_bytes), **extra,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "macs_decision_parent": dec_macs, "macs_chance_parent": ch_macs,
          "chance_parent_share": chance / (B * sims)}


def deep_tree_params(params, bias=SMZ_DEEP_BIAS):
  """``params`` with ``bias`` added to the first entry of the policy head's
  and of the chance head's bias (in place): one action and one outcome
  dominate, and the simulations extend one chain."""
  with torch.no_grad():
    params.prediction.linears()[-2].bias[0] += bias
    params.decision.linears()[-2].bias[0] += bias
  return params


def smz_against_plain(device, num_actions, batch, widths=None,
                      with_invalid=False, max_depth=None, deep=False):
  """Phase 16: the Stochastic MuZero kernel against its plain version on
  the same inputs (seeded weights, ``deep``: with deep_tree_params; roots
  from random CartPole observations, Dirichlet noise from SEED), as
  compare_search; a second launch must give the same bits."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_smz_fns

  net = make_net(device, "smz", num_actions, **(widths or {}))
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  if deep:
    deep_tree_params(params)
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, batch)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
  with torch.no_grad():
    root = make_smz_fns(net, 0.997)[0](params, obs)
  args = (root.embedding.contiguous(),
          fused.noised_root_logits(gen, root.prior_logits, invalid),
          root.value.contiguous(), fused.extract_smz_fused_weights(net, params))
  kwargs = dict(num_simulations=SMZ_SIMS, discount=0.997,
                support_size=net.support_size, invalid_actions=invalid,
                max_depth=max_depth)
  before = search_counts()
  out = fused.fused_smz_search(*args, **kwargs)
  again = fused.fused_smz_search(*args, **kwargs)
  torch.cuda.synchronize()
  got = tuple(a - b for a, b in zip(search_counts(), before))
  check(got == (0, 0, 0, 0, 2),
        f"the wrapper launched the Stochastic MuZero kernel twice, not {got}")
  check(all(torch.equal(a, b) for a, b in zip(out, again)),
        "a repeated Stochastic MuZero launch gives the same bits")
  ref = fused.fused_smz_search_reference(*args, **kwargs)
  return compare_search(out, ref, SMZ_SIMS, invalid)


def copied(tree):
  """A copy of a launch's inputs or outputs (tensors cloned inside tuples,
  named tuples and dicts; the rest kept), so that a later update of the
  parameters in place does not reach it."""
  if torch.is_tensor(tree):
    return tree.clone()
  if isinstance(tree, dict):
    return {k: copied(v) for k, v in tree.items()}
  if isinstance(tree, tuple):
    items = [copied(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
  return tree


class SearchRecorder:
  """Wraps the MLP and categorical search kernel's wrapper
  (``fused._fused_search_cuda``) for a phase: tallies its launches by batch
  size and keeps the arguments and outputs of the first ``keep`` launches,
  of the last, and a copy of the first at each batch size (``first``), so
  the phase can hold what the kernel computed on the main path against the
  plain version on the same inputs. The wrapper itself counts as always."""

  def __init__(self, keep=0):
    from muax_tpu_torch.search import fused
    self.fused, self.keep = fused, keep
    self.by_batch, self.calls, self.last, self.first = {}, [], None, {}

  def __enter__(self):
    self.inner = self.fused._fused_search_cuda

    def recording(*args, **kwargs):
      out = self.inner(*args, **kwargs)
      batch = args[0].shape[0]
      self.by_batch[batch] = self.by_batch.get(batch, 0) + 1
      self.last = (args, kwargs, out)
      if len(self.calls) < self.keep:
        self.calls.append(self.last)
      if batch not in self.first:
        self.first[batch] = copied(self.last)
      return out

    self.fused._fused_search_cuda = recording
    return self

  def __exit__(self, *exc):
    self.fused._fused_search_cuda = self.inner


class FirstCall:
  """Wraps ``owner.name`` for a phase and keeps ``copy`` of the arguments
  (args, kwargs) and a copy of the outputs of its first call (``kept``)."""

  def __init__(self, owner, name, copy):
    self.owner, self.name, self.copy, self.kept = owner, name, copy, None

  def __enter__(self):
    self.inner = getattr(self.owner, self.name)

    def recording(*args, **kwargs):
      out = self.inner(*args, **kwargs)
      if self.kept is None:
        self.kept = self.copy((args, kwargs)) + (copied(out),)
      return out

    setattr(self.owner, self.name, recording)
    return self

  def __exit__(self, *exc):
    setattr(self.owner, self.name, self.inner)


def mlp_plan_figures(device, args, kwargs):
  """The launch plan ``mlp_search_plan`` picks for one recorded launch of
  the MLP search (G, envs per block, embeddings in shared memory or not;
  for towers past a block's shared memory the tile kernel's tile, cluster,
  resident or streamed towers and the runtime's clusters at once)."""
  from muax_tpu_torch.search import fused
  weights = args[3]
  B, A = args[1].shape
  bins = 2 * kwargs.get("support_size", SUPPORT) + 1
  widths = [bins] + [w.shape[1] for w, _ in (
      *weights.dyn_hidden, *weights.pred_hidden)]
  index = device.index if device.index is not None else 0
  plan = fused.mlp_search_plan(
      B, A, args[0].shape[1], kwargs["num_simulations"],
      weights.flat().numel(), widths, "root_score" in kwargs,
      fused.device_limits(device),
      towers=([w.shape[1] for w, _ in weights.dyn_hidden],
              [w.shape[1] for w, _ in weights.pred_hidden]),
      clusters=fused.wide_active_clusters(index))
  return plan._asdict()


def reanalyze_phase(device, t):
  """Phase 21: ``make_reanalyze_fn`` on the ring that phase 6 filled
  (2048 segments of 20 steps) with the MLP triplet at bench widths, 64
  segments (1280 positions) per call, at 64 simulations and at
  ``reanalyze_simulations=16``. Each call launches the MLP search exactly
  once and nothing else; the launch's outputs hold against the plain
  version on its own inputs (phase 1's tolerances, where at most 5 % of
  envs may leave the value or q tolerance as near-ties that an ulp of
  their inputs or f32 rounding alone is shown to move: ``tie_proof``);
  every drawn slot's
  ``target_step`` is the step, every other slot keeps its bits; the two
  draws made equal on purpose give bit-identical rows. Then the call and
  the kernel at 1280 envs are timed, with the plan and the bound."""
  import dataclasses

  from muax_tpu_torch.train.reanalyze import (make_reanalyze_fn,
                                              stalest_first)

  K, L = REANALYZE_SEGMENTS, MAIN_STEPS
  fields = ("obs", "pi", "value", "rn", "step_priorities", "target_step")
  step = t.ts.step + 7
  figures = {}
  for sims in (MAIN_SIMS, REANALYZE_SIMS):
    config = dataclasses.replace(t.config, search=dataclasses.replace(
        t.config.search, reanalyze_simulations=sims))
    reanalyze = make_reanalyze_fn(t.net, config, K, device=device)
    uniforms = torch.rand((K,), generator=t.gen, device=device)
    uniforms[1] = uniforms[0]          # one segment drawn twice
    seg = stalest_first(t.rs, uniforms, step)
    drawn = torch.zeros(t.rs.capacity, dtype=torch.bool, device=device)
    drawn[seg] = True
    before = {k: getattr(t.rs, k).clone() for k in fields}
    reset_counts()
    with SearchRecorder(keep=1) as rec:
      _, metrics = reanalyze(t.ts.params, t.rs, t.gen, step,
                             uniforms=uniforms)
      torch.cuda.synchronize()
    got = search_counts()
    check(got == (1, 0, 0, 0, 0) and rec.by_batch == {K * L: 1},
          f"reanalyze launched the searches {got} at batches "
          f"{rec.by_batch}, not one MLP MuZero launch of {K * L}")
    args, kwargs, out = rec.calls[0]
    check(kwargs["num_simulations"] == sims, "the reanalyze budget")
    cmp = compare_search(out, fused_reference(args, kwargs), sims,
                         tie_proof=tie_proof(args, kwargs))
    check(torch.equal(out[0][:L], out[0][L:2 * L])
          and torch.equal(out[1][:L], out[1][L:2 * L]),
          "a segment drawn twice gives bit-identical rows")
    check(bool((t.rs.target_step[drawn] == step).all()),
          "every refreshed slot's target_step is the step")
    for k in fields:
      check(torch.equal(getattr(t.rs, k)[~drawn], before[k][~drawn]),
            f"slots not drawn keep their {k}")
    visits = t.rs.pi[seg] * sims
    check(torch.allclose(visits, out[0].reshape(K, L, -1), atol=1e-3),
          "the ring holds the launch's visit distribution")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"reanalyze metric {k} is finite")
    entry = dict(cmp, drawn_segments=int(drawn.sum()),
                 value_shift=float(metrics["reanalyze_value_shift"]),
                 target_age=float(metrics["reanalyzed_target_age"]))
    if sims == MAIN_SIMS:
      entry["call_ms"] = time_ms(lambda: reanalyze(
          t.ts.params, t.rs, t.gen, step, uniforms=uniforms), 5)
      entry["search_ms"] = time_ms(
          lambda: fused_cuda(args, kwargs), 10)
      # The same roots cut to training_regime's 1024 envs, beside phase
      # 3's 1024 rollout roots of a fresh net.
      first = tuple(x[:TRAIN_ENVS].contiguous() for x in args[:3]) + (
          args[3],)
      entry[f"search_ms_{TRAIN_ENVS}"] = time_ms(
          lambda: fused_cuda(first, kwargs), 10)
      entry["plain_search_ms"] = time_ms(
          lambda: fused_reference(args, kwargs), 1)
      entry["bound_ms"], entry["bound_by"] = search_bound_ms(
          K * L, sims, args[3], False)
      entry["plan"] = mlp_plan_figures(device, args, kwargs)
    figures[f"sims={sims}"] = entry
  return figures


def fused_cuda(args, kwargs):
  from muax_tpu_torch.search import fused
  return fused._fused_search_cuda(*args, **kwargs)


def smz_cuda(args, kwargs):
  """A Stochastic MuZero search launch on the card (its wrapper counts
  it)."""
  from muax_tpu_torch.search import fused
  return fused.fused_smz_search(*args, **kwargs)


def smz_reference(args, kwargs):
  from muax_tpu_torch.search import fused
  return fused.fused_smz_search_reference(*args, **kwargs)


def compare_masked_smz(out, args, kwargs):
  """Phase 33's rule for one masked Stochastic MuZero launch: phase 22's
  (``compare_masked_search``), where an env whose value leaves the
  tolerance with the same visits must be a near-tie by phase 21's ulp
  nudges of its root embedding and of the towers' weights, in the kernel
  or in the plain version (``ulp_sensitive``; the plain version runs in
  f32 only). The kernel sums each 256-input layer input by input and the
  plain version through torch's products, so a tie below a root can
  break differently."""
  runs = (smz_reference, smz_cuda)
  return compare_masked_search(
      out, args, kwargs, reference_fn=smz_reference,
      proof=lambda idx: ulp_sensitive(args, kwargs, idx, runs=runs))


def fused_reference(args, kwargs):
  """The plain version of a recorded MLP search launch, in its mode."""
  from muax_tpu_torch.search import fused
  if "root_score" in kwargs:
    return fused.fused_gumbel_search_reference(*args, **kwargs)
  return fused.fused_muzero_search_reference(*args, **kwargs)


def drive_reanalyze_fit(device, root):
  """Phase 21's second half: ``fit`` through its normal entry, 3
  iterations of ``training_regime`` with ``reanalyze_every=1`` (64
  segments), eval_every=2. Each iteration launches exactly the training
  iteration's kernels (20 searches of 1024 envs, 10 samplers, 160
  learners; the first also the warm-up iteration's searches) plus one reanalyze
  search of 1280 positions; the evaluations' searches (32 envs) are
  counted apart."""
  import tempfile

  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.train.fit import fit

  config = training_config()
  tcfg = config.train
  group = math.gcd(tcfg.updates_per_iteration, tcfg.presample_updates)
  warm_iters = max(1, config.replay.min_fill // tcfg.num_envs)
  net = make_net(device)
  K = REANALYZE_SEGMENTS
  snapshots = []
  reset_counts()
  with SearchRecorder() as rec:
    def log(line):
      if "iteration=" in line:
        snapshots.append((dict(rec.by_batch), fused_sampler.launches,
                          fused_learner.launches, search_counts()))

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
      _, results = fit(CartPole(), net, config, num_iterations=3, seed=SEED,
                       eval_every=2, log_every=1, model_dir=d,
                       save_best=False, log_fn=log, reanalyze_every=1,
                       reanalyze_segments=K)
    seconds = time.perf_counter() - t0
  check(len(snapshots) == 3, "three logged iterations")
  last = ({}, 0, 0, (0,) * 5)
  per_iteration = []
  for i, snap in enumerate(snapshots):
    by_batch = {b: n - last[0].get(b, 0) for b, n in snap[0].items()}
    searches = {b: n for b, n in by_batch.items() if n}
    want = {TRAIN_ENVS: MAIN_STEPS * (1 + warm_iters if i == 0 else 1),
            K * MAIN_STEPS: 1}
    evals = searches.pop(32, 0)
    check(searches == want, f"iteration {i + 1} launched the MLP search "
          f"{searches} by batch (and {evals} at the evaluation's 32), not "
          f"{want}")
    sampler, learner = snap[1] - last[1], snap[2] - last[2]
    check(sampler == tcfg.updates_per_iteration // group
          and learner == tcfg.updates_per_iteration,
          f"iteration {i + 1} launched {sampler} samplers and {learner} "
          "learners")
    other = tuple(a - b for a, b in zip(snap[3], last[3]))[1:]
    check(other == (0, 0, 0, 0), f"no other search mode: {other}")
    per_iteration.append({"search_by_batch": by_batch, "sampler": sampler,
                          "learner": learner})
    last = snap
  for row in results["history"]:
    for k, v in row.items():
      check(math.isfinite(v), f"fit metric {k} = {v} is finite")
    check(row["reanalyzed_segments"] == K, "reanalyze ran every iteration")
  return {"seconds": seconds, "per_iteration": per_iteration,
          "launches": {"search": snapshots[-1][3][0],
                       "sampler": snapshots[-1][1],
                       "learner": snapshots[-1][2]},
          "loss": results["history"][-1]["loss"],
          "test_G": results["history"][-1].get("test_G")}


def compare_masked_search(out, args, kwargs, reference_fn=None,
                          proof=None):
  """Phase 22's check of one masked launch against the plain version on
  its inputs: visits sum to the simulations and miss every invalid action,
  at least 99 % of envs within 2 visits, and root values within rtol =
  atol = 1e-3 on at least 99 % of envs, where every env outside it is a
  near-tie that rounding breaks: a root visit moved, or one ulp more or
  less on the root embedding moves that env's value past the tolerance in
  the kernel or in the plain version (with ``proof``, envs -> which are
  near-ties, that proof instead, as ``tie_proof`` gives it). Deep trees of
  the board games' nets meet such ties: a tie broken the other way changes
  the subtree, so its values, while the root visits may stay. The launch
  is the MLP search's unless ``reference_fn`` (its plain version) and
  ``proof`` say otherwise."""
  reference_fn = reference_fn or fused_reference
  invalid = kwargs["invalid_actions"]
  sims = kwargs["num_simulations"]
  ref = reference_fn(args, kwargs)
  visits, value, _ = out
  check(bool((visits.sum(-1) == sims).all()) and bool(
      (ref[0].sum(-1) == sims).all()), "visits sum to num_simulations")
  check(float(visits[invalid > 0].abs().sum()) == 0.0,
        "invalid actions get no visits")
  dv = (visits - ref[0]).abs().amax(-1)
  share = float((dv <= 2).float().mean())
  check(share >= 0.99, f"{share:.4f} of envs within 2 visits (need 0.99)")

  off = outside(value, ref[1])
  unexplained = off & (dv == 0)
  if bool(unexplained.any()) and proof is not None:
    idx = torch.nonzero(unexplained)[:, 0]
    unexplained[idx] = ~proof(idx)
  elif bool(unexplained.any()):
    for scale in (1 + 2 ** -23, 1 - 2 ** -23):
      nudged = (args[0] * scale,) + tuple(args[1:])
      unexplained &= ~outside(fused_cuda(nudged, kwargs)[1], value)
      unexplained &= ~outside(reference_fn(nudged, kwargs)[1], ref[1])
  check(not bool(unexplained.any()), f"{int(unexplained.sum())} envs whose "
        "root value leaves rtol = atol = 1e-3 with the same visits and no "
        "sensitivity to an ulp of the embedding")
  share_values = 1.0 - float(off.float().mean())
  check(share_values >= 0.99, f"{share_values:.4f} of envs with the root "
        "value within rtol = atol = 1e-3 (need 0.99)")
  near = ~off
  return ref, {"within_2_visits": share,
               "exact_visits": float((dv == 0).float().mean()),
               "values_within_tolerance": share_values,
               "near_ties": int(off.sum()),
               "max_abs_err": float((value[near] - ref[1][near]).abs().max())}


def masked_rollout(device, game, policy, envs, steps):
  """Phase 22: ``make_rollout_fn`` on a board game with the MLP triplet at
  bench widths, ``envs`` x 64 simulations x ``steps``: exactly ``steps``
  launches of the policy's mode and none of the other, every action legal
  under the mask read before its step, no weight on an illegal action;
  the last step's launch against the plain version on its masked roots
  (the first step's are fresh boards, every action legal), as
  ``compare_masked_search`` holds them (Gumbel: also the same action on
  at least 99 % of envs)."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper
  from muax_tpu_torch.train import make_rollout_fn

  env = AutoResetWrapper(game)
  A = env.spec.num_actions
  net = make_net(device, "mlp", A)
  params = net.init_params(env.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      train=TrainConfig(num_envs=envs, collect_steps=steps))
  rollout = make_rollout_fn(net, env, config, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = env.reset(gen, envs)
  masks = []
  read = env.legal_action_mask
  env.legal_action_mask = lambda c: masks.append(read(c)) or masks[-1]
  mode = search_mode(policy, "mlp")
  reset_counts()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  with SearchRecorder() as rec:
    start.record()
    _, seg, prio, metrics = rollout(params, carry, gen, params.temperature)
    end.record()
    end.synchronize()
  got = search_counts()
  want = tuple(steps if i == mode else 0 for i in range(len(got)))
  check(got == want, f"{policy} rollout on {type(game).__name__} launched "
        f"{got}, not {want}")
  legal = torch.stack(masks, dim=1)                        # [B, T, A]
  check(len(masks) == steps, "one mask read per step")
  taken = torch.gather(legal, 2, seg.action.long()[..., None])[..., 0]
  check(bool((taken == 1).all()), "every action is legal under its mask")
  check(float(seg.pi[legal == 0].abs().sum()) == 0.0,
        "no weight on an illegal action")
  check(bool(torch.isfinite(prio).all()) and bool(
      torch.isfinite(seg.value).all()), "finite values and priorities")
  args, kwargs, out = rec.last
  invalid = kwargs["invalid_actions"]
  check(invalid is not None and bool(torch.equal(invalid, 1.0 - masks[-1]))
        and bool((invalid > 0).any()),
        "the last launch searched under the last mask, which masks actions")
  ref, figures = compare_masked_search(out, args, kwargs)
  if policy == "gumbel":
    def act(res):
      visits, _, cq = res
      score = torch.where(visits == visits.amax(-1, keepdim=True),
                          kwargs["root_score"] + cq, -torch.inf)
      return torch.argmax(torch.where(invalid > 0, -torch.inf, score), -1)
    figures["same_action"] = float((act(out) == act(ref)).float().mean())
    check(figures["same_action"] >= 0.99, "the Gumbel action agrees on "
          f"{figures['same_action']:.4f} of envs (need 0.99)")
  rollout_ms = start.elapsed_time(end)
  figures.update(
      launches=got[mode], rollout_ms=rollout_ms,
      env_steps_per_s=envs * steps / (rollout_ms / 1e3),
      episodes_finished=int(metrics["episodes_finished"]),
      illegal_share_of_actions=float((legal == 0).float().mean()),
      plan=mlp_plan_figures(device, args, kwargs))
  return figures, (args, kwargs)


def alphazero_phase(device):
  """Phase 23: AlphaZero on Connect Four at bench.py's alphazero_connect4
  (``make_az_resnet(7, channels=32, num_blocks=4)``, 256 envs x 64
  simulations, 21 moves an iteration, batch 512, 8 updates, a ring of
  4096, adam at 2e-3): one warm-up iteration and two timed ones through
  the generic engine, with no launch of any of the port's kernels; every
  move legal, the losses finite. Then the device's idle share from
  ``torch.profiler`` (device activity only) over one move and, apart, the
  8 updates, weighted by their share of the iteration; and
  ``evaluate_vs_random`` over 64 games."""
  from muax_tpu_torch.envs import ConnectFour
  from muax_tpu_torch.models import create_optimizer, make_az_resnet
  from muax_tpu_torch.replay import replay_add, replay_init
  from muax_tpu_torch.train.selfplay import (AZConfig, evaluate_vs_random,
                                             make_az_policy_fn,
                                             make_az_selfplay_fn,
                                             make_az_update_fn)

  game = ConnectFour()
  net = make_az_resnet(7, channels=32, num_blocks=4, device=device)
  config = AZConfig(num_simulations=MAIN_SIMS, num_envs=AZ_ENVS,
                    collect_steps=AZ_MOVES, batch_size=512,
                    updates_per_iteration=8, replay_capacity=4096)
  params = net.init_params((6, 7, 2), torch.Generator().manual_seed(SEED))
  optimizer = create_optimizer("adam", lr=2e-3)
  opt_state = optimizer.init(params)
  gen = torch.Generator(device=device).manual_seed(SEED)
  state, _ = game.reset(gen, AZ_ENVS)
  replay = replay_init(config.replay_capacity, AZ_MOVES, (6, 7, 2), 7,
                       device=device)
  selfplay = make_az_selfplay_fn(game, net, config)
  update = make_az_update_fn(net, optimizer, config)

  def one():
    nonlocal state, params, opt_state
    state, seg, prio, metrics = selfplay(params, state, gen, 1.0)
    # A live game's legal columns are those whose top cell is empty.
    legal = seg.obs[:, :, 0, :, :].sum(-1) == 0
    check(bool(torch.gather(legal, 2, seg.action.long()[..., None]).all()),
          "every self-play move is legal")
    replay_add(replay, seg, prio)
    for _ in range(config.updates_per_iteration):
      params, opt_state, _, m = update(params, opt_state, replay, gen)
    for k, v in m.items():
      check(math.isfinite(float(v)), f"AZ metric {k} = {float(v)} is finite")
    return metrics, m

  reset_counts()
  t0 = time.perf_counter()
  one()
  torch.cuda.synchronize()
  warmup_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  for _ in range(AZ_TIMED):
    metrics, m = one()
  torch.cuda.synchronize()
  iteration_ms = (time.perf_counter() - t0) / AZ_TIMED * 1e3
  check(all_kernel_launches() == 0, "AlphaZero launched none of the port's "
        "kernels")
  policy_fn = make_az_policy_fn(game, net, MAIN_SIMS)

  def move():
    policy_fn(params, gen, state, 1.0)

  def updates():
    nonlocal params, opt_state
    for _ in range(config.updates_per_iteration):
      params, opt_state, _, _ = update(params, opt_state, replay, gen)

  profile = {"move": profile_window(move),
             "updates": profile_window(updates)}
  if None not in (profile["move"]["idle_share"],
                  profile["updates"]["idle_share"]):
    moves_ms = AZ_MOVES * profile["move"]["window_ms"]
    profile["device_idle_share"] = (
        profile["move"]["idle_share"] * moves_ms
        + profile["updates"]["idle_share"] * profile["updates"]["window_ms"]
    ) / (moves_ms + profile["updates"]["window_ms"])
  t0 = time.perf_counter()
  score = evaluate_vs_random(game, net, params, gen, num_games=AZ_EVAL_GAMES)
  check(-1.0 <= score <= 1.0, f"evaluate_vs_random gave {score}")
  check(all_kernel_launches() == 0, "no kernel launch in the evaluation")
  moves = AZ_ENVS * AZ_MOVES
  return {"iteration_ms": iteration_ms, "warmup_ms": warmup_ms,
          "moves_per_s": moves / (iteration_ms / 1e3),
          "mcts_sims_per_s": moves * MAIN_SIMS / (iteration_ms / 1e3),
          "learner_updates_per_s": config.updates_per_iteration
          / (iteration_ms / 1e3),
          "episodes_finished": int(metrics["episodes_finished"]),
          "loss": float(m["loss"]), "profile": profile,
          "vs_random": score,
          "vs_random_seconds": time.perf_counter() - t0}


def env_model_phase(device):
  """Phase 24: the env models on Catch (10 x 5), 1024 envs x 64
  simulations: one step of the simulator's policy and one of the learned
  model's, over ``make_mlp_transition_model(hidden=(64, 64))`` and an AZ
  MLP, then 10 SGD steps of ``make_model_update_fn`` on a ring of the
  env's transitions. Shapes, pi sums to 1, everything finite, no kernel
  launch."""
  from muax_tpu_torch.envs import Catch
  from muax_tpu_torch.models import (ModelSearchParams, create_optimizer,
                                     fused_learner, make_az_mlp,
                                     make_mlp_transition_model,
                                     make_model_policy_fn,
                                     make_model_update_fn,
                                     make_simulator_policy_fn,
                                     model_replay_add, model_replay_init)
  from muax_tpu_torch.replay import fused_sampler

  game = Catch()
  B = TRAIN_ENVS
  net = make_az_mlp(3, device=device)
  params = net.init_params(game.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  model = make_mlp_transition_model(3, game.spec.observation_shape,
                                    hidden=(64, 64), device=device)
  mparams = model.init_params(torch.Generator().manual_seed(SEED + 1))
  gen = torch.Generator(device=device).manual_seed(SEED)
  state, obs = game.reset(gen, B)
  reset_counts()
  figures = {}
  for name, run in (
      ("simulator", lambda: make_simulator_policy_fn(
          game, net, MAIN_SIMS)(params, gen, state, obs, 1.0)),
      ("model", lambda: make_model_policy_fn(model, net, MAIN_SIMS)(
          ModelSearchParams(params, mparams), gen, obs, 1.0))):
    t0 = time.perf_counter()
    action, pi, value = run()
    torch.cuda.synchronize()
    check(tuple(action.shape) == (B,) and tuple(pi.shape) == (B, 3)
          and tuple(value.shape) == (B,), f"{name} policy shapes")
    check(torch.allclose(pi.sum(-1), torch.ones(B, device=device),
                         atol=1e-5), f"{name} pi rows sum to 1")
    check(bool(torch.isfinite(value).all()), f"{name} values finite")
    figures[name] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                     "mean_root_value": float(value.mean())}
  ring = model_replay_init(4096, game.spec.observation_shape, device=device)
  while ring.size < 1024:
    action = torch.randint(0, 3, (B,), generator=gen, device=device)
    nxt_state, nxt_obs, reward, done = game.step(state, action)
    model_replay_add(ring, obs, action, reward, nxt_obs, done)
    state, obs = nxt_state, nxt_obs
  optimizer = create_optimizer("adam", lr=1e-3)
  update = make_model_update_fn(model, optimizer, batch_size=256,
                                num_sgd_steps=10)
  mparams, _, metrics = update(mparams, optimizer.init(mparams), ring, gen)
  for k, v in metrics.items():
    check(math.isfinite(float(v)), f"model metric {k} is finite")
  check(float(metrics["model_loss"]) > 0, "the ring was full enough to train")
  check(sum(search_counts()) + fused_sampler.launches
        + fused_learner.launches == 0, "no kernel launch")
  figures["update"] = {k: float(v) for k, v in metrics.items()}
  return figures


# ---- the conv and pixel path (phases 25-29) --------------------------------


def all_kernel_launches():
  """Launches of every kernel of the port, in every mode."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  return (sum(search_counts()) + fused_sampler.launches
          + fused_learner.launches + fused_learner.categorical_launches)


def pixel_ring(device, frame=EZ_SMALL_FRAME):
  """Phase 25's ring: TRAIN_CAPACITY segments of MAIN_STEPS steps of uint8
  PixelCatch at scale 1 played by a uniform random policy, with their
  n-step returns (of zero values), random policy targets and priorities.
  Returns the ring and the generator."""
  from muax_tpu_torch.envs import AutoResetWrapper, PixelCatch
  from muax_tpu_torch.ops import segment_n_step_returns
  from muax_tpu_torch.replay import replay_add, replay_init
  from muax_tpu_torch.types import Transition

  env = AutoResetWrapper(PixelCatch(frame[0], frame[1], scale=1,
                                    dtype=torch.uint8))
  gen = torch.Generator(device=device).manual_seed(SEED)
  B, T = TRAIN_CAPACITY, MAIN_STEPS
  carry = env.reset(gen, B)
  steps = []
  for _ in range(T):
    action = torch.randint(0, 3, (B,), generator=gen, device=device,
                           dtype=torch.int32)
    obs = carry.obs
    carry, reward, done, _ = env.step(carry, action, gen)
    steps.append((obs, action, reward, done))
  obs, action, reward, done = (torch.stack(x, 1).contiguous()
                               for x in zip(*steps))
  value = torch.zeros_like(reward)
  rn = segment_n_step_returns(reward.T, value.T, done.T.float(), 0.997,
                              TRAIN_NSTEP).T.contiguous()
  pi = torch.softmax(torch.randn((B, T, 3), generator=gen, device=device), -1)
  ring = replay_init(TRAIN_CAPACITY, T, frame, 3, obs_dtype=torch.uint8,
                     device=device)
  replay_add(ring, Transition(
      obs=obs, action=action, reward=reward, done=done, rn=rn, value=value,
      pi=pi, weight=torch.ones(B, device=device),
      mask=torch.ones((B, T), device=device)),
      torch.rand((B, T), generator=gen, device=device) + 0.05)
  check(ring.obs.dtype == torch.uint8 and int(ring.obs.max()) == 1
        and bool(ring.done.any()), "a uint8 ring of Catch frames with dones")
  return ring, gen


def uint8_sampler_phase(device):
  """Phase 25: the sampler kernel on a uint8 ring (PixelCatch 10 x 5 at
  scale 1: 50 features), W = 16,384 windows in both modes. Against its
  plain version (the start agrees on 99.99 % of windows, where it agrees
  every raw row is equal) and against the same kernel on the ring cast to
  f32 (bit-identical rows); timed on both rings, with the bound of each."""
  import dataclasses

  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.replay.buffer import gumbel_noise

  ring, gen = pixel_ring(device)
  as_f32 = dataclasses.replace(ring, obs=ring.obs.float())
  W = EZ_GROUP_WINDOWS
  out = {}
  for per_step in (False, True):
    seg_idx = fused_sampler.draw_segments(ring, gen, W)
    gumbel = gumbel_noise(gen, (MAIN_STEPS, W), device)
    args = (seg_idx, gumbel, TRAIN_UNROLL)

    def sample(state, per_step=per_step, args=args):
      return fused_sampler.fused_sample_group(state, *args,
                                              per_step_obs=per_step)

    before = fused_sampler.launches
    raw, lay = sample(ring)
    torch.cuda.synchronize()
    check(fused_sampler.launches == before + 1,
          "the sampler launched on the uint8 ring")
    check(lay.O == 50, f"{lay.O} observation features, not 50")
    fig = compare_raw(raw, fused_sampler.fused_sample_group_reference(
        ring, *args, per_step_obs=per_step)[0], lay)
    check(torch.equal(raw, sample(as_f32)[0]),
          "the uint8 ring's rows equal the f32 ring's bit for bit")
    fig["bit_identical_to_f32_ring"] = True
    fig["ms"] = time_ms(lambda: sample(ring), 20)
    fig["f32_ring_ms"] = time_ms(lambda: sample(as_f32), 20)
    fig["plain_ms"] = time_ms(
        lambda: fused_sampler.fused_sample_group_reference(
            ring, *args, per_step_obs=per_step), 3)
    fig["bound_ms"], fig["bound_by"] = sampler_bound_ms(lay, W, MAIN_STEPS,
                                                        obs_bytes=1)
    fig["f32_ring_bound_ms"] = sampler_bound_ms(lay, W, MAIN_STEPS)[0]
    out["per_step_obs" if per_step else "start_obs"] = fig
  return out


def seeded_conv_batch(A, B, K, frame, integer, seed):
  """A [B, K] window batch on the CPU: uint8 frames or 0/1 planes."""
  from muax_tpu_torch.types import Transition
  gen = torch.Generator().manual_seed(seed)
  if integer:
    obs = torch.randint(0, 256, (B, K) + frame, generator=gen,
                        dtype=torch.uint8)
  else:
    obs = torch.randint(0, 2, (B, K) + frame, generator=gen).float()
  mask = (torch.arange(K)[None, :]
          < torch.randint(1, K + 1, (B, 1), generator=gen)).float()
  return Transition(
      obs=obs,
      action=torch.randint(0, A, (B, K), generator=gen, dtype=torch.int32),
      reward=torch.randn((B, K), generator=gen),
      done=torch.zeros((B, K), dtype=torch.bool),
      rn=torch.randn((B, K), generator=gen) * 3,
      value=torch.zeros((B, K)),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen), -1),
      weight=torch.rand(B, generator=gen) + 0.5,
      mask=mask)


def conv_against_cpu(device):
  """Phase 26: the EfficientZero triplet at bench.py's width (80 x 40 x 1
  uint8 frames) and the ResNet triplet at its defaults (Connect Four's
  planes) on the card against the same weights on the CPU, in f32 with
  TF32 off: representation, prediction and dynamics outputs on 16
  observations, rtol 1e-4 / atol 1e-5; one ``muzero_loss`` gradient on 16
  windows of 5 steps, rtol 1e-4 / atol 1e-5 with cuDNN off (the card's
  own CUDA convolutions) and, for the EfficientZero triplet, under cuDNN's
  default algorithms, which the path runs. The ResNet's gradient under
  cuDNN is held to ``RESNET_CUDNN_GRAD_SHARE`` of its largest entry
  instead: cuDNN's f32 convolutions err by about 1e-5 of a weight
  gradient's largest entry, which the 64-channel ResNet's unroll compounds
  to 1.5e-4, while TF32 or bf16 compute lands far above the limit
  (``tools/conv_precision.py``). Each of the three f32 gradients' error
  against a float64 gradient on the CPU is reported."""
  import dataclasses

  from muax_tpu_torch.models import (make_efficientzero_networks,
                                     make_resnet_networks)
  from muax_tpu_torch.models.losses import muzero_grad

  cases = {"efficientzero": (make_efficientzero_networks, EZ_NET, EZ_FRAME,
                             3, True),
           "resnet": (make_resnet_networks, RESNET_NET, RESNET_PLANES, 7,
                      False)}
  cpu = torch.device("cpu")

  def moved(batch, d, dtype=torch.float32):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(
            d, dtype if getattr(batch, f.name).is_floating_point()
            else None) for f in dataclasses.fields(batch)})

  out = {}
  for name, (make, widths, frame, A, integer) in cases.items():
    batch = seeded_conv_batch(A, 16, TRAIN_UNROLL, frame, integer, SEED + 1)
    runs = {}
    for label, d, dtype, cudnn in (("cpu_f64", cpu, torch.float64, True),
                                   ("cpu", cpu, torch.float32, True),
                                   ("card", device, torch.float32, True),
                                   ("card_cudnn_off", device, torch.float32,
                                    False)):
      net = make(A, device=d, **widths)
      params = net.init_params(frame, torch.Generator().manual_seed(SEED))
      params = params.to(dtype)
      on = moved(batch, d, dtype)
      # Only the switch: torch.backends.cudnn.flags would reset the rest
      # (TF32 among them) to its own defaults.
      torch.backends.cudnn.enabled = cudnn
      try:
        with torch.no_grad():
          s = params.representation(on.obs[:, 0])
          policy, value = params.prediction(s)
          reward, nxt = params.dynamic(s, on.action[:, 0])
        grads, metrics = muzero_grad(params, on, net)
      finally:
        torch.backends.cudnn.enabled = True
      runs[label] = [t.cpu().double() for t in (s, policy, value, reward,
                                                nxt, grads, metrics.total)]
    err = 0.0
    for got, ref in zip(runs["card"][:5], runs["cpu"][:5]):
      check(got.shape == ref.shape and torch.allclose(
          got, ref, rtol=1e-4, atol=1e-5), f"{name} outputs agree")
      err = max(err, float((got - ref).abs().max()))
    grad_err, used = grads_close(runs["card_cudnn_off"][5], runs["cpu"][5],
                                 1e-4, 1e-5)
    scale = float(runs["cpu"][5].abs().max())
    cudnn_err = float((runs["card"][5] - runs["cpu"][5]).abs().max())
    if name == "efficientzero":
      grads_close(runs["card"][5], runs["cpu"][5], 1e-4, 1e-5)
    else:
      check(cudnn_err <= RESNET_CUDNN_GRAD_SHARE * scale,
            f"{name} gradient under cuDNN off by {cudnn_err:.3g}, "
            f"{cudnn_err / scale:.3g} of its largest entry (limit "
            f"{RESNET_CUDNN_GRAD_SHARE})")
    check(torch.allclose(runs["card"][6], runs["cpu"][6], rtol=1e-4),
          f"{name} loss agrees")
    out[name] = {
        "latent": list(runs["cpu"][0].shape[1:]), "max_abs_err": err,
        "grad_max_abs_err_cudnn_off": grad_err,
        "grad_tolerance_used_cudnn_off": used,
        "grad_max_abs_err_cudnn": cudnn_err,
        "grad_err_share_of_largest_cudnn": cudnn_err / scale,
        "grad_err_vs_f64": {k: float((runs[k][5] - runs["cpu_f64"][5])
                                     .abs().max())
                            for k in ("cpu", "card", "card_cudnn_off")},
        "loss": float(runs["cpu"][6])}
  return out


def ez_config(envs, batch, updates=None, sims=EZ_SIMS):
  """bench.py's run_config for network="ez_conv": MuZero at 32 simulations,
  a ring of max(2048, 2 x envs) segments, min_fill 64, unroll 5, n-step
  10, presample 64, updates set by samples per insert 32 unless given."""
  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  return MuZeroConfig(
      search=SearchConfig(num_simulations=sims),
      replay=ReplayConfig(capacity=max(TRAIN_CAPACITY, 2 * envs),
                          min_fill=64),
      train=TrainConfig(
          num_envs=envs, collect_steps=MAIN_STEPS, batch_size=batch,
          updates_per_iteration=updates or -(-int(TRAIN_SPI) * envs
                                             * MAIN_STEPS // batch),
          unroll_steps=TRAIN_UNROLL, n_bootstrap=TRAIN_NSTEP,
          presample_updates=EZ_PRESAMPLE))


def ez_setup(device, envs, batch):
  """The EZ path built from the port's entry points: uint8 PixelCatch at
  bench.py's size, the EfficientZero triplet at its width with random
  weights from SEED, the rollout, the ring and the env carry."""
  from types import SimpleNamespace

  from muax_tpu_torch.envs import AutoResetWrapper, PixelCatch
  from muax_tpu_torch.models import make_efficientzero_networks
  from muax_tpu_torch.replay import replay_init
  from muax_tpu_torch.train import make_policy_fn, make_rollout_fn

  config = ez_config(envs, batch)
  env = AutoResetWrapper(PixelCatch(10, 5, scale=8, dtype=torch.uint8))
  check(env.spec.observation_shape == EZ_FRAME
        and env.spec.obs_dtype == torch.uint8, "80 x 40 x 1 uint8 frames")
  net = make_efficientzero_networks(3, device=device, **EZ_NET)
  gen = torch.Generator(device=device).manual_seed(SEED)
  return SimpleNamespace(
      config=config, env=env, net=net, gen=gen,
      params=net.init_params(EZ_FRAME, torch.Generator().manual_seed(SEED)),
      rollout=make_rollout_fn(net, env, config, device=device),
      policy=make_policy_fn(net, config, config.train.discount,
                            device=device),
      ring=replay_init(config.replay.capacity, MAIN_STEPS, EZ_FRAME, 3,
                       obs_dtype=torch.uint8, device=device),
      carry=env.reset(gen, envs))


def ez_rollout_phase(device):
  """Phase 27: ``make_rollout_fn`` at muzero_ez_conv_pixel (512 envs x 32
  simulations x 20 steps, 80 x 40 x 1 uint8 frames) through the generic
  engine: one warm-up step and one timed rollout, no launch of any kernel
  of the port; the segments' shapes and dtypes, pi rows summing to 1,
  finite values. Then one step (the policy and the env) under the
  profiler: launches a step and the device's idle share."""
  t = ez_setup(device, EZ_ROLLOUT_ENVS, 128)

  def step():
    action, _, _ = t.policy(t.params, t.gen, t.carry.obs, 1.0)
    t.carry, _, _, _ = t.env.step(t.carry, action, t.gen)

  reset_counts()
  t0 = time.perf_counter()
  step()
  torch.cuda.synchronize()
  warmup_ms = (time.perf_counter() - t0) * 1e3
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  t.carry, seg, prio, metrics = t.rollout(t.params, t.carry, t.gen, 1.0)
  end.record()
  end.synchronize()
  rollout_ms = start.elapsed_time(end)
  check(all_kernel_launches() == 0, "the EZ rollout launched none of the "
        "port's kernels")
  B, T = EZ_ROLLOUT_ENVS, MAIN_STEPS
  check(tuple(seg.obs.shape) == (B, T) + EZ_FRAME
        and seg.obs.dtype == torch.uint8, "uint8 frames in the segments")
  check(torch.allclose(seg.pi.sum(-1), torch.ones((B, T), device=device),
                       atol=1e-5), "pi rows sum to 1")
  check(bool(((seg.action >= 0) & (seg.action < 3)).all()), "actions")
  check(bool(torch.isfinite(seg.value).all() and torch.isfinite(prio).all()),
        "finite values and priorities")
  prof = profile_window(step)
  check(all_kernel_launches() == 0, "no kernel launch")
  return {"rollout_ms": rollout_ms, "warmup_step_ms": warmup_ms,
          "env_steps_per_s": B * T / (rollout_ms / 1e3),
          "mcts_sims_per_s": B * T * EZ_SIMS / (rollout_ms / 1e3),
          "episodes_finished": int(metrics["episodes_finished"]),
          "mean_root_value": float(metrics["mean_root_value"]),
          "step_ms": prof["window_ms"],
          "launches_per_step": prof["kernel_launches"],
          "device_idle_share": prof["idle_share"], "profile": prof}


def ez_training_phase(device, full=False):
  """Phase 28: ez_conv_training (256 envs x 32 simulations x 20 steps,
  batch 256, 640 updates in groups of 64) and ez_conv_training_b1024
  (batch 1024, 160 updates in groups of 32) on one rollout, which fills
  the ring. The 3200-feature ring takes ``replay_sample``
  (``fused_status`` gives the reason) and autograd: no launch of any
  kernel of the port. Each regime runs one group of its updates (64 and
  32), or with ``full`` all of them (the time limit of a smoke run has no
  room for 800 updates at 50-90 ms of host work each): ms an update,
  learner windows/s, the iteration's ms (the rollout and every update:
  measured with ``full``, else the rollout plus the updates at the
  measured ms an update), launches an update and the device's idle share
  (a policy step and 8 updates under the profiler, weighted by the
  rollout's and the updates' time), peak memory. Then one gradient step
  at batch 256 in bf16 with remat against f32, each timed with its peak
  memory."""
  import dataclasses

  from muax_tpu_torch.fused_status import fused_status
  from muax_tpu_torch.models import muzero_optimizer
  from muax_tpu_torch.models.losses import muzero_grad
  from muax_tpu_torch.replay import replay_add, replay_sample
  from muax_tpu_torch.train import TrainState, make_multi_update_fn

  t = ez_setup(device, EZ_TRAIN_ENVS, EZ_BATCHES[0])
  optimizer = muzero_optimizer()
  ts = TrainState(t.params, optimizer.init(t.params), 0)
  reset_counts()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  t.carry, seg, prio, _ = t.rollout(ts.params, t.carry, t.gen, 1.0)
  replay_add(t.ring, seg, prio, step=ts.step)
  end.record()
  end.synchronize()
  rollout_ms = start.elapsed_time(end)

  def step():
    action, _, _ = t.policy(ts.params, t.gen, t.carry.obs, 1.0)
    t.carry, _, _, _ = t.env.step(t.carry, action, t.gen)

  step_profile = profile_window(step)
  out = {"rollout_ms": rollout_ms, "full": full,
         "launches_per_step": step_profile["kernel_launches"],
         "step_profile": step_profile}
  for batch in EZ_BATCHES:
    config = ez_config(EZ_TRAIN_ENVS, batch)
    updates = config.train.updates_per_iteration
    group = math.gcd(updates, config.train.presample_updates)
    if not full:
      config = dataclasses.replace(config, train=dataclasses.replace(
          config.train, updates_per_iteration=group))
    ran = config.train.updates_per_iteration
    multi_update = make_multi_update_fn(t.net, optimizer, config)
    status = fused_status(t.net, config, ts.params, t.ring, optimizer)
    check(status["fused_sampler"]["reason"] == "obs features 3200 > 64 "
          "(pixel rings take replay_sample)", f"sampler {status}")
    check(not status["fused_search"]["active"]
          and not status["fused_learner"]["active"], f"no kernel {status}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start.record()
    ts, _, metrics = multi_update(ts, t.ring, t.gen)
    end.record()
    end.synchronize()
    check(all_kernel_launches() == 0, "the EZ training iteration launched "
          "none of the port's kernels")
    check(metrics["updates_done"] == ran,
          f"{metrics['updates_done']} updates, not {ran}")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"metric {k} = {float(v)} is finite")
    ms_per_update = start.elapsed_time(end) / ran
    iteration_ms = rollout_ms + ms_per_update * updates
    fig = {"updates": updates, "group": group, "updates_timed": ran,
           "ms_per_update": ms_per_update, "iteration_ms": iteration_ms,
           "env_steps_per_s": EZ_TRAIN_ENVS * MAIN_STEPS
           / (iteration_ms / 1e3),
           "learner_windows_per_s": updates * batch / (iteration_ms / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 2**30,
           "loss": float(metrics["loss"]),
           "sampler_reason": status["fused_sampler"]["reason"]}

    def some_updates(multi_update=multi_update):
      nonlocal ts
      ts, _, _ = multi_update(ts, t.ring, t.gen, EZ_PROFILE_UPDATES)

    prof = profile_window(some_updates)
    if None not in (step_profile["idle_share"], prof["idle_share"]):
      fig["device_idle_share"] = (
          step_profile["idle_share"] * rollout_ms
          + prof["idle_share"] * ms_per_update * updates) / iteration_ms
    launches = prof["kernel_launches"]
    fig["launches_per_update"] = (None if launches is None
                                  else launches / EZ_PROFILE_UPDATES)
    fig["updates_profile"] = prof
    out[f"batch_{batch}"] = fig
  check(all_kernel_launches() == 0, "no kernel launch")

  batch, _, _ = replay_sample(t.ring, t.gen, EZ_BATCHES[0], TRAIN_UNROLL)
  grad = {}
  for name, kwargs in (("f32", {}), ("bf16_remat", dict(
      compute_dtype=torch.bfloat16, remat=True))):
    def one(kwargs=kwargs):
      return muzero_grad(ts.params, batch, t.net, **kwargs)
    g, metrics = one()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    g, metrics = one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    check(g.dtype == torch.float32 and bool(torch.isfinite(g).all()),
          f"{name} gradient f32 and finite")
    grad[name] = {"ms": time_ms(one, 5), "peak_memory_gb": peak / 2**30,
                  "loss": float(metrics.total), "grad": g}
  g0, g1 = grad["f32"].pop("grad"), grad["bf16_remat"].pop("grad")
  cos = float(torch.dot(g0, g1) / (g0.norm() * g1.norm() + 1e-12))
  check(cos > 0.98, f"bf16 + remat gradient cosine {cos} against f32")
  grad["cosine"] = cos
  out["grad_step_batch_256"] = grad
  return out


def ez_fit_phase(device, root):
  """Phase 29: ``fit`` for 2 iterations on uint8 PixelCatch 10 x 5 at
  scale 1 (50 features) with the EfficientZero triplet without
  downsampling at 32 channels and 2 blocks, 64 envs x 8 simulations and
  two groups of 64 updates of 256 windows an iteration: the hybrid route,
  the sampler kernel's per_step_obs mode on the uint8 ring, one launch a
  group, no search or learner launch."""
  import tempfile

  from muax_tpu_torch.envs import PixelCatch
  from muax_tpu_torch.models import make_efficientzero_networks
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.train.fit import fit

  config = ez_config(EZ_FIT_ENVS, EZ_BATCHES[0], updates=2 * EZ_PRESAMPLE,
                     sims=EZ_FIT_SIMS)
  tcfg = config.train
  groups = tcfg.updates_per_iteration // math.gcd(
      tcfg.updates_per_iteration, tcfg.presample_updates)
  net = make_efficientzero_networks(3, downsample=False, device=device,
                                    **EZ_NET)
  env = PixelCatch(EZ_SMALL_FRAME[0], EZ_SMALL_FRAME[1], scale=1,
                   dtype=torch.uint8)
  lines = []
  os.makedirs(os.path.join(root, "build"), exist_ok=True)
  reset_counts()
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
    _, results = fit(env, net, config, num_iterations=2, seed=SEED,
                     eval_every=2, log_every=1, model_dir=d,
                     log_fn=lines.append)
  seconds = time.perf_counter() - t0
  check("sampler=on" in lines[0] and "search=OFF" in lines[0]
        and "learner=OFF" in lines[0], f"fit's route: {lines[0]}")
  sampler = fused_sampler.launches
  check(sampler == 2 * groups, f"{sampler} sampler launches in 2 "
        f"iterations of {groups} groups")
  check(all_kernel_launches() == sampler, "no search or learner launch")
  check(len(results["history"]) == 2, "two logged iterations")
  for row in results["history"]:
    for k, v in row.items():
      check(math.isfinite(v), f"fit metric {k} = {v} is finite")
  last = results["history"][-1]
  return {"seconds": seconds, "status": lines[0],
          "launches": {"sampler_per_step_obs": sampler, "search": 0,
                       "learner": 0},
          "groups_per_iteration": groups, "loss": last["loss"],
          "test_G": last.get("test_G"),
          "env_steps_per_s": last["env_steps_per_s"]}


# ---- phase 30: the host-environment path at the 2048 example's width -------

def host_boards(device, envs, moves):
  """``envs`` boards of the native 2048 pool after ``moves`` seeded random
  legal moves: their observations [envs, 4, 4] and legal masks [envs, 4]."""
  from muax_tpu_torch.envs.native2048 import Native2048Pool

  pool = Native2048Pool(envs, seed=SEED, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = pool.reset(gen, envs)
  for _ in range(moves):
    action = torch.multinomial(carry.env_state, 1, generator=gen)[:, 0]
    carry, _, _, _ = pool.step(carry, action.to(torch.int32), gen)
  return carry.obs, carry.env_state


def wide_search_against_plain(device, net, params, obs, legal, policy):
  """Phase 30: the search kernel's wide mode (``fused_search_wide_kernel``:
  tiles of environments sharing every tower read) in ``policy`` on the
  roots of real boards under their legal masks, against its plain version
  as phase 22 holds masked launches (Gumbel: also the same action on at
  least 99 % of envs), a repeated launch bit-identical; timed, with the
  plan, the bound (f32 FMA and 3xTF32) and the weight bytes: those the
  launch's products use (every tile reads every weight each simulation)
  and those its blocks copy from L2 into shared memory (each rank's share
  once where resident, once a simulation where streamed; a model from the
  plan's layout, not a measured L2 count)."""
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn

  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  invalid = (1.0 - legal).contiguous()
  logits = torch.where(invalid > 0, -1e9, root.prior_logits).contiguous()
  weights = fused.extract_fused_weights(net, params)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          weights)
  kwargs = dict(num_simulations=HOST_SIMS, support_size=net.support_size,
                discount=0.999, invalid_actions=invalid, max_depth=None)
  gumbel = policy == "gumbel"
  if gumbel:
    noise = gumbel_noise(torch.Generator(device=device).manual_seed(SEED),
                         tuple(logits.shape), device)
    kwargs["root_score"], kwargs["schedule"] = fused.gumbel_root_inputs(
        logits, noise, invalid, max_num_considered_actions=16,
        num_simulations=HOST_SIMS)
  check(bool((invalid > 0).any()), "the boards' masks have illegal moves")
  before = fused.wide_gumbel_launches if gumbel else fused.wide_launches
  out = fused_cuda(args, kwargs)
  again = fused_cuda(args, kwargs)
  torch.cuda.synchronize()
  check((fused.wide_gumbel_launches if gumbel else fused.wide_launches)
        == before + 2, "the wide search kernel launched")
  check(all(torch.equal(a, b) for a, b in zip(out, again)),
        "a repeated wide search launch gives the same bits")
  # Phase 21's proof for the envs outside the tolerance: the tile kernel's
  # 3xTF32 products sum each layer in another order than the plain
  # version, so a tie below a root can break the other way where an ulp
  # of the root embedding alone (phase 22's proof) does not move it.
  ref, figures = compare_masked_search(out, args, kwargs,
                                       proof=tie_proof(args, kwargs))
  if gumbel:
    def act(res):
      visits, _, cq = res
      score = torch.where(visits == visits.amax(-1, keepdim=True),
                          kwargs["root_score"] + cq, -torch.inf)
      return torch.argmax(torch.where(invalid > 0, -torch.inf, score), -1)
    figures["same_action"] = float((act(out) == act(ref)).float().mean())
    check(figures["same_action"] >= 0.99, "the Gumbel action agrees on "
          f"{figures['same_action']:.4f} of envs (need 0.99)")
  plan = mlp_plan_figures(device, args, kwargs)
  check("tile" in plan, f"the tile kernel takes the wide towers: {plan}")
  B, n = obs.shape[0], weights.flat().numel()
  figures["ms"] = time_ms(lambda: fused_cuda(args, kwargs), 5)
  figures["plain_ms"] = once_ms(lambda: fused_reference(args, kwargs))
  figures["bound_ms"], figures["bound_by"] = search_bound_ms(
      B, HOST_SIMS, weights, True, gumbel=gumbel)
  figures["bound_ms_3xtf32"], _ = search_bound_ms(
      B, HOST_SIMS, weights, True, gumbel=gumbel, peak=PEAK_3XTF32_FLOPS)
  tiles = -(-B // plan["tile"])
  figures["weight_bytes_requested"] = 4 * tiles * HOST_SIMS * n
  lay = fused.wide_layout(
      plan["tile"], plan["cluster"], 1 << 20, 4, net.embedding_dim,
      2 * net.support_size + 1, HOST_SIMS, net.dyn_layers, net.pred_layers,
      plan["resident"], plan["ring"], plan["smem_trees"])
  weight_floats = lay.rank_floats - lay.bias_floats
  figures["weight_bytes_from_l2"] = 4 * tiles * plan["cluster"] * (
      lay.bias_floats + weight_floats * (1 if plan["resident"]
                                         else HOST_SIMS))
  figures["weight_tb_per_s_from_l2"] = (
      figures["weight_bytes_from_l2"] / figures["ms"] / 1e9)
  figures["plan"] = plan
  return figures


def wide_learner_against_plain(device, net, params, obs):
  """Phase 30: the learner's wide mode (the example's triplet, 2.3 MB of
  weights: ``mlp_cluster_kernel`` on clusters of blocks per 16 windows,
  then the weight-gradient pass) against autograd over ``muzero_loss`` at
  batch 256, K = 5, on windows of real boards with seeded actions,
  rewards, returns and policies, as phase 5 holds it (the scratch filled
  with NaN before each launch, a repeated launch bit-identical); timed,
  each kernel's device time, the plan (with the runtime's blocks an SM
  and clusters at once), the bound (f32 FMA and 3xTF32) and the weight
  bytes the cluster pass requests (each tile reads every linear's weights
  for each of its row blocks in the forward and again in the backward,
  its blocks each a share of the columns)."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.types import Transition

  B, K = HOST_BATCH, HOST_UNROLL
  gen = torch.Generator(device=device).manual_seed(SEED + 3)
  pick = torch.randint(0, obs.shape[0], (B, K), generator=gen, device=device)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=device)
  merges = torch.rand((B, K), generator=gen, device=device) < 0.4
  batch = Transition(
      obs=obs.reshape(obs.shape[0], -1)[pick],
      action=torch.randint(0, 4, (B, K), generator=gen, device=device),
      reward=torch.where(merges, 2.0 ** torch.randint(
          2, 9, (B, K), generator=gen, device=device).float(), 0.0),
      done=torch.zeros((B, K), dtype=torch.bool, device=device),
      rn=torch.rand((B, K), generator=gen, device=device) * 400.0,
      value=torch.zeros((B, K), device=device),
      pi=torch.softmax(torch.randn((B, K, 4), generator=gen,
                                   device=device), -1),
      weight=torch.rand((B,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  lw = fused_learner.extract_learner_weights(net, params)
  limits = fused_learner.device_limits(device)
  plan = fused_learner.mlp_learner_plan(B, K, lw, limits)
  check(not plan.smem_arena and plan.cluster > 0,
        f"the learner's cluster pass takes the wide towers: {plan}")
  wide_before = fused_learner.wide_launches
  kw = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)

  def poison():
    torch.full((plan.scratch_floats,), float("nan"), device=device)

  before = fused_learner.launches
  poison()
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, lw, **kw)
  poison()
  again, _ = fused_learner.fused_muzero_grad_raw(params, raw, coef, lay, net,
                                                 lw, **kw)
  torch.cuda.synchronize()
  check(fused_learner.launches == before + 2
        and fused_learner.wide_launches == wide_before + 2,
        "the learner's cluster pass launched")
  check(torch.equal(grads, again), "a repeated launch gives bit-identical "
        "gradients")
  ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
      params, raw, coef, lay, net, **kw)
  err, used = grads_close(grads, ref_grads, 2e-4, 1e-6)
  metrics_close(metrics, ref_metrics)

  def launch():
    return fused_learner._grad_cuda(lw, raw, coef, lay, l2_coef=1e-4,
                                    gradient_scale=0.5)

  n = lw.flat.numel()
  towers = (sum((i + 1) * o for i, o, steps, _ in
                fused_learner._mlp_linears(lw) if not steps),
            sum((i + 1) * o for i, o, steps, _ in
                fused_learner._mlp_linears(lw) if steps))
  n_pred = sum((i + 1) * o for i, o, _, _ in
               fused_learner._mlp_linears(lw)[len(lw.repr_layers) + 1:
                                              len(lw.repr_layers) + 1
                                              + len(lw.pred_layers) + 2])
  # The representation once and the prediction once (all K steps' rows in
  # one product), the dynamics once a step; forward and backward.
  per_block = 2 * (towers[0] + n_pred + K * (towers[1] - n_pred))
  ms = time_ms(launch, 10)
  bound, bound_by = learner_bound_ms(net, lay, B, n)
  bound_tc, _ = learner_bound_ms(net, lay, B, n, peak=PEAK_3XTF32_FLOPS)
  runtime = fused_learner.learner_blocks_per_sm(plan, device)
  check(runtime == plan.blocks_per_sm, f"the plan's {plan.blocks_per_sm} "
        f"blocks an SM are the runtime's {runtime}")
  clusters = fused_learner.learner_active_clusters(plan, device)
  check(clusters * plan.cluster >= plan.blocks, f"{clusters} clusters of "
        f"{plan.cluster} at once hold the launch's {plan.blocks} blocks")
  return {"max_abs_err": err, "tolerance_used": used, "ms": ms,
          "device_ms_by_kernel": kernel_device_ms(launch, 5),
          "plain_ms": once_ms(lambda: fused_learner
                              .fused_muzero_grad_raw_reference(
                                  params, raw, coef, lay, net, **kw)),
          "bound_ms": bound, "bound_ms_3xtf32": bound_tc,
          "bound_by": bound_by,
          "weight_bytes_requested": 4 * (plan.blocks // plan.cluster)
          * per_block,
          "plan": dict(plan._asdict(), runtime_blocks_per_sm=runtime,
                       runtime_active_clusters=clusters)}


def host_fit_phase(device, root):
  """Phase 30's fit: ``examples/run_2048.py``'s pool, evaluation pool,
  networks, config and optimizer, ``HOST_ITERATIONS`` iterations with the
  greedy evaluation at the first, under ``torch.profiler`` (device
  activity). The launch counts are reset just before and read just after:
  (2 warm-up + HOST_ITERATIONS) x 32 MuZero searches of 64 boards and one
  of 16 boards a step of the evaluation, 2 sampler launches (16 updates in
  groups of 8) and 16 learner launches an iteration, nothing else. Every
  action of either pool is legal under the mask of the board it is taken
  on. The pool's step is timed in parts: the wait for the device (the
  search), then the step itself (the actions' copy to the host, the C++
  step, the copy of observations, rewards, dones and masks to the card)."""
  import statistics
  import tempfile

  from torch.profiler import ProfilerActivity, profile

  from muax_tpu_torch.examples import run_2048
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.fit import fit

  pool, eval_pool, net, config, optimizer = run_2048.setup(seed=SEED,
                                                           device=device)
  tcfg = config.train
  legal_taken = []
  parts = {k: [] for k in ("enter", "synced", "exit", "cxx", "h2d")}
  eval_steps = [0]

  def timed(fn, key):
    def call(*a):
      t = time.perf_counter()
      out = fn(*a)
      parts[key].append(time.perf_counter() - t)
      return out
    return call

  def instrument(p, train):
    real = p.step

    def step(carry, action, gen):
      t0 = time.perf_counter()
      torch.cuda.synchronize()
      t1 = time.perf_counter()
      legal_taken.append(carry.env_state.gather(1, action.long()[:, None]))
      out = real(carry, action, gen)
      if train:
        parts["enter"].append(t0)
        parts["synced"].append(t1)
        parts["exit"].append(time.perf_counter())
      else:
        eval_steps[0] += 1
      return out
    p.step = step
    if train:
      p._host_step = timed(p._host_step, "cxx")
      p._upload = timed(p._upload, "h2d")

  instrument(pool, True)
  instrument(eval_pool, False)
  lines = []
  os.makedirs(os.path.join(root, "build"), exist_ok=True)
  reset_counts()
  t0 = time.perf_counter()
  with SearchRecorder() as rec, profile(
      activities=[ProfilerActivity.CUDA]) as prof:
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
      _, results = fit(pool, net, config, optimizer,
                       num_iterations=HOST_ITERATIONS, seed=SEED,
                       eval_every=25, log_every=1, model_dir=d,
                       eval_env=eval_pool, log_fn=lines.append)
    torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  got = search_counts()
  warm = max(1, config.replay.min_fill // tcfg.num_envs)
  rollouts = (warm + HOST_ITERATIONS) * tcfg.collect_steps
  groups = tcfg.updates_per_iteration // math.gcd(
      tcfg.updates_per_iteration, tcfg.presample_updates)
  check("search=on" in lines[0] and "learner=on" in lines[0]
        and "sampler=on" in lines[0], f"fit's route: {lines[0]}")
  check(rec.by_batch == {HOST_ENVS: rollouts, 16: eval_steps[0]},
        f"search launches by batch {rec.by_batch}, not {rollouts} of "
        f"{HOST_ENVS} and {eval_steps[0]} of 16")
  check(got == (rollouts + eval_steps[0], 0, 0, 0, 0),
        f"search launches by mode {got}")
  check((fused.wide_launches, fused.wide_gumbel_launches)
        == (rollouts + eval_steps[0], 0),
        f"{fused.wide_launches} of the searches went through the tile kernel")
  check(fused_learner.wide_launches == fused_learner.launches,
        f"{fused_learner.wide_launches} of {fused_learner.launches} learner "
        "launches went through the cluster pass")
  check(fused_sampler.launches == HOST_ITERATIONS * groups,
        f"{fused_sampler.launches} sampler launches")
  check(fused_learner.launches == HOST_ITERATIONS
        * tcfg.updates_per_iteration and
        fused_learner.categorical_launches == 0,
        f"{fused_learner.launches} learner launches")
  taken = torch.cat(legal_taken)
  check(bool((taken == 1).all()), f"{int((taken != 1).sum())} actions "
        "illegal under their masks")
  check(len(results["history"]) == HOST_ITERATIONS, "every iteration logged")
  for row in results["history"]:
    for k, v in row.items():
      check(math.isfinite(v), f"fit metric {k} = {v} is finite")
  kernels = [e for e in prof.key_averages()
             if getattr(e, "device_type", None) is not None
             and "CUDA" in str(e.device_type)]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  # The second iteration's clock also holds the evaluation after the first.
  steady = [row for row in results["history"] if row["iteration"] != 2]
  sps = [row["env_steps_per_s"] for row in steady]
  per_iter = tcfg.num_envs * tcfg.collect_steps
  enter, synced, out = parts["enter"], parts["synced"], parts["exit"]
  period = [b - a for a, b in zip(out, out[1:]) if b - a < 1.0]
  step_s = [c - b for b, c in zip(synced, out)]
  med = statistics.median
  step_ms = med(period) * 1e3
  host = {
      "step_ms": step_ms,
      "wait_device_ms": med([b - a for a, b in zip(enter, synced)]) * 1e3,
      "pool_step_ms": med(step_s) * 1e3,
      "cxx_step_ms": med(parts["cxx"]) * 1e3,
      "h2d_ms": med(parts["h2d"]) * 1e3,
      "d2h_and_glue_ms": med([s - c - h for s, c, h in zip(
          step_s, parts["cxx"], parts["h2d"])]) * 1e3,
  }
  host["host_share_of_step"] = host["pool_step_ms"] / step_ms
  last = results["history"][-1]
  return {"seconds": seconds, "status": lines[0],
          "launches": {"search": got[0], "search_eval": eval_steps[0],
                       "search_wide": fused.wide_launches,
                       "sampler": fused_sampler.launches,
                       "learner": fused_learner.launches,
                       "learner_wide": fused_learner.wide_launches},
          "iteration_ms": [per_iter / v * 1e3 for v in sps],
          "env_steps_per_s": sps, "host": host,
          "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms
          / (seconds * 1e3),
          "kernel_launches": sum(e.count for e in kernels),
          "test_G": results["history"][0].get("test_G"),
          "loss": last["loss"], "mean_episode_return": [
              row["mean_episode_return"] for row in results["history"]]}


def host_2048_phase(device, root, ptxas):
  """Phase 30: the wide-tower modes of the search and learner kernels
  against their plain versions at the 2048 example's width, then fit on
  the native pool (``host_fit_phase``)."""
  from muax_tpu_torch.examples import run_2048

  _, _, net, _, _ = run_2048.setup(num_envs=1, device=device)
  params = net.init_params((4, 4), torch.Generator().manual_seed(SEED))
  obs, legal = host_boards(device, HOST_CHECK_ENVS, HOST_BOARD_MOVES)
  search = {f"{policy}_{B}": wide_search_against_plain(
      device, net, params, obs[:B].contiguous(), legal[:B].contiguous(),
      policy)
            for policy in ("muzero", "gumbel")
            for B in (HOST_ENVS, HOST_CHECK_ENVS)}
  learner = wide_learner_against_plain(device, net, params, obs)
  instances = {k.split(":", 1)[1]: v for k, v in ptxas.items()
               if "fused_search_wide_kernel" in k
               or "mlp_cluster_kernel" in k or "categorical_dw_kernel" in k}
  return {"search": search, "learner": learner, "instances": instances,
          "fit": host_fit_phase(device, root)}


# ---- phase 31: the host-facing surface (no kernel on its path) ------------


def host_ms(fn):
  """Wall time of one call of ``fn``, synchronized at both ends, and its
  result: for the generic engine's calls, whose time is the host's."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - t0), out


def launches_and_idle(fn, ms):
  """Kernel launches of one more call of ``fn`` (``torch.profiler``, device
  activity) and the device's idle share against ``ms``, the unprofiled
  call's wall time."""
  prof = profile_iteration(fn, host_ops=False)
  busy = prof["device_busy_ms"]
  return {"kernel_launches": prof["kernel_launches"],
          "device_busy_ms": busy,
          "idle_share": None if busy is None else 1.0 - busy / ms}


def sampled_phase(device):
  """Phase 31 (a): Sampled MuZero on tests/test_sampled.py's Gaussian
  bandit (reward -(a - 1)^2, discount 0, a uniform empirical prior over K =
  4 iid draws) and its delayed-reward case (slot 0 pays 10 one step later,
  max depth 2) at ``SAMPLED_ROOTS`` roots: every root's best slot (slot 0
  in the delayed case) has the most visits, and every root picks it or a
  slot that ties it on visits (at temperature 0 the action is drawn among
  the slots of most visits; at 1024 roots about 1 % of the Gaussian roots
  draw two candidates close enough that PUCT splits the visits evenly).
  The share that picks the best slot itself, the ms of a policy call
  (host clock: the generic engine is launch-bound) and its launches."""
  from muax_tpu_torch.search import (ContinuousRecurrentFnOutput,
                                     RootFnOutput, make_gaussian_sample_fn,
                                     sampled_muzero_policy)

  B = SAMPLED_ROOTS
  gen = torch.Generator(device).manual_seed(SEED)
  zeros = lambda *shape: torch.zeros(shape, device=device)
  gaussian = make_gaussian_sample_fn(
      lambda p, s: (zeros(s.shape[0], 1), zeros(s.shape[0], 1)),
      num_samples=4)

  def gaussian_fn(p, g, s):
    return gaussian(p, g, s)[0], None

  def quadratic(p, g, action, state):
    reward = -torch.square(action[:, 0] - 1.0)
    return ContinuousRecurrentFnOutput(
        reward=reward, discount=torch.zeros_like(reward),
        value=torch.zeros_like(reward)), state

  grid = torch.tensor([0.0, 1.0], device=device)

  def grid_fn(p, g, s):
    return grid[None, :, None].expand(s.shape[0], 2, 1), None

  def delayed(p, g, action, state):
    entered = state[:, 0] > 0.5
    reward = torch.where(entered, 10.0,
                         torch.where(action[:, 0] > 0.5, 1.0, 0.0))
    return ContinuousRecurrentFnOutput(
        reward=reward, discount=torch.where(entered, 0.0, 0.9),
        value=torch.zeros_like(reward)), torch.where(
            action[:, 0:1] < 0.5, torch.ones_like(state),
            torch.zeros_like(state))

  cases = {
      "gaussian_k4": (gaussian_fn, quadratic, 4, None, 1),
      "delayed_k2_depth2": (grid_fn, delayed, 2, 2, 1)}
  figures = {}
  for name, (sample_fn, recurrent_fn, K, depth, dim) in cases.items():
    root = RootFnOutput(prior_logits=zeros(B, K), value=zeros(B),
                        embedding=zeros(B, dim))

    def call():
      return sampled_muzero_policy(
          (), gen, root, sample_fn=sample_fn, recurrent_fn=recurrent_fn,
          num_simulations=SAMPLED_SIMS, num_samples=K, max_depth=depth,
          dirichlet_fraction=0.0, temperature=0.0)

    t0 = time.perf_counter()
    ms, out = host_ms(call)
    if name == "gaussian_k4":
      best = torch.argmin((out.sampled_actions[..., 0] - 1.0).abs(), 1)
    else:
      best = torch.zeros(B, dtype=torch.long, device=device)
    visits = out.search_tree.summary().visit_counts
    rows = torch.arange(B, device=device)
    top = visits.amax(-1)
    slot = out.action_slot.long()
    picked = float((slot == best).float().mean())
    check(bool((visits.sum(-1) == SAMPLED_SIMS).all()),
          f"sampled {name}: visits sum to the simulation count")
    # At temperature 0 the action is drawn among the slots of most visits;
    # where another slot ties the best one on visits, it may be drawn.
    check(bool((visits[rows, best] == top).all()
               & (visits[rows, slot] == top).all()),
          f"sampled {name}: every root's best slot has the most visits, "
          f"and the pick ties it")
    figures[name] = {"policy_ms": ms, "best_slot_share": picked,
                     **launches_and_idle(call, ms)}
    figures[name]["launches_per_simulation"] = (
        figures[name]["kernel_launches"] / SAMPLED_SIMS
        if figures[name]["kernel_launches"] else None)
    figures[name]["seconds"] = time.perf_counter() - t0
  return figures


def cpu_twin(agent, make_agent):
  """An agent on the CPU (``make_agent("cpu")``) with ``agent``'s
  parameters and optimizer state."""
  from muax_tpu_torch.train.checkpoint import to_numpy, to_torch

  twin = make_agent("cpu")
  params = twin.networks.init_params(agent.observation_shape)
  params.load_state_dict({k: v.cpu() for k, v in
                          agent.params.state_dict().items()})
  twin.init(None, torch.zeros((1,) + agent.observation_shape),
            params=params)
  twin.opt_state = to_torch(to_numpy(agent.opt_state), "cpu")
  return twin


def same_step_on_cpu(agent, make_agent, batch, card_kwargs=None,
                     cpu_kwargs=None):
  """One update of ``agent`` and of its CPU twin from the same parameters,
  optimizer state and batch: the parameters agree to rtol 1e-4 / atol
  1e-6 (TF32 is off), the loss to rtol 1e-5."""
  twin = cpu_twin(agent, make_agent)
  loss_card = agent.update(batch, **(card_kwargs or {}))
  loss_cpu = twin.update(batch, **(cpu_kwargs or {}))
  err, worst = 0.0, 0.0
  for a, b in zip(agent.params.parameters(), twin.params.parameters()):
    diff = (a.detach().cpu() - b.detach()).abs()
    err = max(err, float(diff.max()))
    worst = max(worst, float((diff - 1e-4 * b.detach().abs()).max()))
  check(worst <= 1e-6, f"{type(agent).__name__}: one update on the card "
        f"and on the CPU agree to rtol 1e-4 / atol 1e-6 (max abs err {err})")
  check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu),
        f"{type(agent).__name__}: the loss on the card and on the CPU")
  return {"max_abs_err": err, "loss_card": loss_card, "loss_cpu": loss_cpu}


def play_cartpole(agent, device, watch, monitor):
  """The reference's single-env workflow (README.md:99-143 of muax): one
  CartPole on the card, ``act`` at AGENT_SIMS simulations, the popped
  steps of a PNStep(10, 0.997) into a Trajectory an episode, each into a
  TrajectoryReplayBuffer. Returns the buffer and every (action, pi sum)."""
  from muax_tpu_torch import PNStep, Trajectory, TrajectoryReplayBuffer
  from muax_tpu_torch.envs import CartPole

  env = CartPole()
  env_gen = torch.Generator(device).manual_seed(SEED)
  act_gen = torch.Generator(device).manual_seed(SEED + 1)
  tracer = PNStep(10, AGENT_DISCOUNT)
  buffer = TrajectoryReplayBuffer(capacity=500, seed=SEED)
  acts, lengths = [], []
  for _ in range(AGENT_EPISODES):
    state, obs = env.reset(env_gen, 1)
    trajectory = Trajectory()
    ret = 0.0
    for t in range(AGENT_EPISODE_CAP):
      with watch.time("act"):
        a, pi, v = agent.act(act_gen, obs[0], with_pi=True, with_value=True,
                             num_simulations=AGENT_SIMS)
        action, pi_host, value = int(a), pi.cpu().numpy(), float(v)
      with watch.time("env_step"):
        state, next_obs, reward, done = env.step(state, a.reshape(1))
        reward, done = float(reward[0]), bool(done[0])
      last = done or t == AGENT_EPISODE_CAP - 1
      tracer.add(obs[0].cpu().numpy(), action, reward, last, value, pi_host)
      while tracer:
        trajectory.add(tracer.pop())
      acts.append((action, float(pi_host.sum())))
      ret += reward
      obs = next_obs
      if last:
        break
    monitor.observe_rollout(t + 1, 1, ret)
    lengths.append(t + 1)
    buffer.add(trajectory)
  return buffer, acts, lengths


def muzero_agent_phase(device):
  """Phase 31 (b): the MuZero agent at the CartPole notebook triplet on the
  card: the single-env workflow (``play_cartpole``), counted with
  ``TrainMonitor(None)`` and timed with ``Stopwatch``; AGENT_UPDATES
  updates on batches of 256 windows, the first of which is the fixed
  batch whose loss must be lower after them; one more update on the card
  and on the CPU from the same state (``same_step_on_cpu``); save and
  load, after which ``act`` with the same generator seed gives the same
  action, pi and value; and one batched ``act`` over 256 observations,
  timed, with its launches and the device's idle share."""
  import numpy as np

  from muax_tpu_torch import MuZero
  from muax_tpu_torch.agents.muzero import transition_to_device
  from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
  from muax_tpu_torch.models.losses import muzero_loss
  from muax_tpu_torch.monitor import TrainMonitor
  from muax_tpu_torch.utils import Stopwatch

  def make_agent(dev):
    return MuZero(make_mlp_networks(2, device=dev, **AGENT_NET),
                  optimizer=muzero_optimizer(**AGENT_OPTIMIZER),
                  discount=AGENT_DISCOUNT, unroll_steps=AGENT_UNROLL)

  agent = make_agent(device)
  agent.init(SEED, np.zeros((1, 4), np.float32))
  watch, monitor = Stopwatch(), TrainMonitor(None)
  t_play = time.perf_counter()
  buffer, acts, lengths = play_cartpole(agent, device, watch, monitor)
  play_s = time.perf_counter() - t_play
  check(all(a in (0, 1) for a, _ in acts), "every action lies in {0, 1}")
  pi_err = max(abs(s - 1.0) for _, s in acts)
  check(pi_err <= 1e-5, f"every pi sums to 1 (off by {pi_err})")
  counters = monitor.flush()
  check(counters["T"] == len(acts) and counters["ep"] == AGENT_EPISODES,
        "the monitor counted every step and episode")

  def sample():
    return buffer.sample(AGENT_TRAJECTORIES, AGENT_WINDOWS,
                         k_steps=AGENT_UNROLL)

  fixed = sample()
  fixed_dev = transition_to_device(fixed, device)

  def fixed_loss():
    with torch.no_grad():
      return float(muzero_loss(agent.params, fixed_dev, agent.networks,
                               num_unroll_steps=AGENT_UNROLL)[0])

  loss_before = fixed_loss()
  for i in range(AGENT_UPDATES):
    batch = fixed if i == 0 else sample()
    with watch.time("update"):
      loss = agent.update(batch)
    check(math.isfinite(loss), "finite loss")
  loss_after = fixed_loss()
  check(loss_after < loss_before, f"the loss on the fixed batch fell over "
        f"{AGENT_UPDATES} updates ({loss_before} -> {loss_after})")
  cpu = same_step_on_cpu(agent, make_agent, sample())

  import tempfile
  obs = torch.from_numpy(np.array(fixed.obs[0, 0])).to(device)
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "muzero_agent.ckpt")
    agent.save(path)
    loaded = make_agent(device).load(path)
  outs = [a.act(torch.Generator(device).manual_seed(SEED + 2), obs,
                with_pi=True, with_value=True, num_simulations=AGENT_SIMS)
          for a in (agent, loaded)]
  check(all(torch.equal(x, y) for x, y in zip(*outs)),
        "after save/load, act with the same seed gives the same action, pi "
        "and value")

  obs_batch = torch.from_numpy(np.array(fixed.obs[:AGENT_BATCH_OBS, 0])).to(
      device)
  act_gen = torch.Generator(device).manual_seed(SEED + 3)

  def batched_act():
    return agent.act(act_gen, obs_batch, obs_from_batch=True, with_pi=True,
                     num_simulations=AGENT_SIMS)

  t_batched = time.perf_counter()
  ms, (action, pi) = host_ms(batched_act)
  check(bool(((action == 0) | (action == 1)).all()), "batched actions valid")
  check(bool(torch.allclose(pi.sum(-1), torch.ones_like(pi[:, 0]),
                            atol=1e-5)), "batched pi rows sum to 1")
  batched = {"act_ms": ms, **launches_and_idle(batched_act, ms)}
  batched["launches_per_simulation"] = (
      batched["kernel_launches"] / AGENT_SIMS
      if batched["kernel_launches"] else None)
  batched["seconds"] = time.perf_counter() - t_batched
  means = watch.means_ms()
  return {"episode_lengths": lengths, "acts": len(acts), "play_s": play_s,
          "act_ms": means["act"], "env_step_ms": means["env_step"],
          "update_ms": means["update"], "monitor": counters,
          "fixed_batch_loss": [loss_before, loss_after],
          "card_vs_cpu_update": cpu, "batched_act_256": batched}, buffer


def surface_agents_phase(device, buffer):
  """Phase 31 (c) and (d): the Stochastic MuZero agent at bench.py's
  smz_mlp widths (its default 200 sims) and the Diffusion MuZero agent at
  ``make_diffusion_mlp_networks(2)``'s defaults (50 sims): a batched
  ``act`` over SURFACE_OBS observations each (the decision weights sum to
  1), then updates on batches from the MuZero agent's buffer; the
  diffusion agent's flow loss on a fixed batch before and after its
  updates, and one update on the card and on the CPU with the same
  injected flow draws."""
  import numpy as np

  from muax_tpu_torch.agents import DiffusionMuZero, StochasticMuZero
  from muax_tpu_torch.agents.muzero import transition_to_device
  from muax_tpu_torch.models import (make_diffusion_mlp_networks,
                                     make_stochastic_mlp_networks)
  from muax_tpu_torch.models.diffusion_losses import diffusion_muzero_loss

  def sample():
    return buffer.sample(AGENT_TRAJECTORIES, AGENT_WINDOWS,
                         k_steps=AGENT_UNROLL)

  fixed = sample()
  obs = torch.from_numpy(np.array(fixed.obs[:SURFACE_OBS, 0])).to(device)
  makers = {
      "stochastic": lambda dev: StochasticMuZero(
          make_stochastic_mlp_networks(2, device=dev, **SMZ_NET)),
      "diffusion": lambda dev: DiffusionMuZero(
          make_diffusion_mlp_networks(2, device=dev))}
  figures = {}
  for name, make_agent in makers.items():
    t_agent = time.perf_counter()
    agent = make_agent(device)
    agent.init(SEED, np.zeros((1, 4), np.float32))
    sims = agent.DEFAULT_SIMULATIONS
    gen = torch.Generator(device).manual_seed(SEED)

    def act():
      return agent.act(gen, obs, obs_from_batch=True, with_pi=True)

    ms, (action, pi) = host_ms(act)
    check(bool(((action == 0) | (action == 1)).all()),
          f"{name} agent: actions valid")
    check(bool(torch.allclose(pi.sum(-1), torch.ones_like(pi[:, 0]),
                              atol=1e-5)),
          f"{name} agent: the decision weights sum to 1")
    fig = {"simulations": sims, "act_ms": ms, **launches_and_idle(act, ms)}
    fig["launches_per_simulation"] = (fig["kernel_launches"] / sims
                                      if fig["kernel_launches"] else None)
    updates = (SMZ_AGENT_UPDATES if name == "stochastic"
               else DMZ_AGENT_UPDATES)
    fixed_dev = transition_to_device(fixed, device)

    def flow_loss():
      with torch.no_grad():
        return float(diffusion_muzero_loss(
            agent.params, fixed_dev, agent.networks,
            torch.Generator(device).manual_seed(0),
            num_unroll_steps=agent.unroll_steps)[1].flow_loss)

    if name == "diffusion":
      fig["flow_loss_before"] = flow_loss()
    update_ms, losses = [], []
    for _ in range(updates):
      batch = sample()
      ms, loss = host_ms(lambda: agent.update(batch))
      check(math.isfinite(loss), f"{name} agent: finite loss")
      update_ms.append(ms)
      losses.append(loss)
    fig.update(updates=updates, update_ms=sum(update_ms) / updates,
               loss_first_last=[losses[0], losses[-1]])
    if name == "diffusion":
      fig["flow_loss_after"] = flow_loss()
      B, E = AGENT_TRAJECTORIES * AGENT_WINDOWS, agent.networks.embedding_dim
      g = torch.Generator().manual_seed(SEED)
      draws = [(torch.rand(B, generator=g), torch.randn(B, E, generator=g))
               for _ in range(agent.unroll_steps - 1)]
      fig["card_vs_cpu_update"] = same_step_on_cpu(
          agent, make_agent, sample(),
          card_kwargs={"draws": [(t.to(device), e.to(device))
                                 for t, e in draws]},
          cpu_kwargs={"draws": draws})
    fig["seconds"] = time.perf_counter() - t_agent
    figures[name] = fig
  return figures


def surface_phase(device):
  """Phase 31: the host-facing surface on the card, with every kernel's
  launch count set to 0 just before and required to be 0 just after: the
  JAX agents search with the generic engine and learn with autograd, on
  the TPU too, so no kernel serves this path."""
  reset_counts()
  sampled = sampled_phase(device)
  muzero, buffer = muzero_agent_phase(device)
  others = surface_agents_phase(device, buffer)
  launches = all_kernel_launches()
  check(launches == 0, f"phase 31 launched no kernel ({launches})")
  return {"sampled": sampled, "muzero_agent": muzero, **{
      f"{k}_agent": v for k, v in others.items()},
      "kernel_launches": launches}


# ---- phase 32: the parallel layer over torch.distributed -----------------


def rank_setup():
  """A spawned rank's card (the machine's one card for every rank) with
  TF32 off, as ``main`` sets it."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.cuda.set_device(0)
  return torch.device("cuda", 0)


def rank_launches():
  """(search MuZero, sampler, learner MLP) launch counts of this process."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  return (search_counts()[0], fused_sampler.launches, fused_learner.launches)


def flat_state(ts):
  """The flat parameters and the optimizer state's tensors, on the host."""
  from muax_tpu_torch.models.optimizers import flat_parameters
  opt = [x.reshape(-1).double() for x in ts.opt_state
         if isinstance(x, torch.Tensor)]
  return torch.cat([flat_parameters(ts.params).double()] + opt).cpu()


def gathered(x):
  """The host tensor ``x`` of every rank, gathered through the default
  group, in rank order."""
  import torch.distributed as dist
  parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
  dist.all_gather(parts, x)
  return parts


def all_reduce_ms(numel, device):
  """Host ms of one all-reduce over the default group of a float tensor of
  ``numel`` on ``device`` (the flat gradient's size), synchronized: the
  learner's one collective an update."""
  import torch.distributed as dist
  x = torch.ones(numel, device=device)
  dist.all_reduce(x)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(PAR_ALL_REDUCE_REPS):
    dist.all_reduce(x)
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / PAR_ALL_REDUCE_REPS


def sharded_program(device, reanalyze_segments=0):
  """``make_sharded_program`` at ``training_regime`` (the global config of
  phase 6) on a 1-D data mesh of every rank, with phase 6's triplet."""
  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import muzero_optimizer
  from muax_tpu_torch.parallel import make_mesh, make_sharded_program
  net, optimizer = make_net(device), muzero_optimizer()
  mesh = make_mesh(device="cuda")
  program = make_sharded_program(net, AutoResetWrapper(CartPole()),
                                 training_config(), optimizer, mesh,
                                 reanalyze_segments=reanalyze_segments)
  return net, optimizer, program


def sharded_iterations(program, warmup, timed, state_check=False):
  """``warmup`` + ``timed`` iterations of ``program`` from its init, with
  every launch count set to 0 before them. Every iteration must launch
  exactly 20 searches, updates / 16 samplers and one learner an update on
  this rank; with ``state_check``, after each one the parameters and the
  optimizer state must be bit-identical on every rank."""
  ts, rs, carry = program.init(SEED)
  cfg = program.local_config.train
  expected = (MAIN_STEPS, cfg.updates_per_iteration // TRAIN_GROUP,
              cfg.updates_per_iteration)
  reset_counts()
  times = []
  for i in range(warmup + timed):
    before = rank_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, rs, carry, metrics = program.iteration(ts, rs, carry, i)
    torch.cuda.synchronize()
    if i >= warmup:
      times.append((time.perf_counter() - t0) * 1e3)
    got = tuple(a - b for a, b in zip(rank_launches(), before))
    check(got == expected, f"rank launches (search, sampler, learner) {got} "
          f"in one sharded iteration, not {expected}")
    check(int(metrics["updates_done"]) == cfg.updates_per_iteration,
          f"{float(metrics['updates_done'])} updates in a sharded iteration")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"sharded metric {k} = {float(v)}")
    if state_check:
      parts = gathered(flat_state(ts))
      check(all(torch.equal(p, parts[0]) for p in parts),
            f"parameters and optimizer state differ across the ranks after "
            f"iteration {i}")
  check(rs.total_added == cfg.num_envs * (warmup + timed),
        f"total_added {rs.total_added}, not {cfg.num_envs} envs x "
        f"{warmup + timed} iterations")
  return ts, rs, carry, {"iteration_ms": sum(times) / timed,
                         "iteration_ms_each": times,
                         "loss": float(metrics["loss"]),
                         "total_added": rs.total_added}


def reduction_meaning(net, program, ts, rs, optimizer, group):
  """Phase 32 (c): one update, from the same state and draws, once without
  a group (this rank's own gradient) and once over the data group, with an
  optimizer that records the gradient ``_finish`` hands it. The mean of the
  ranks' own gradients (summed in rank order, divided by the count) must
  equal the reduced gradient bit for bit: a sum of two rounds the same in
  either order."""
  import copy
  import dataclasses

  from muax_tpu_torch.models.optimizers import GradientTransformation
  from muax_tpu_torch.train import TrainState, make_multi_update_fn

  seen = []

  def update(grads, state, params):
    seen.append(grads.detach().clone())
    return optimizer.update(grads, state, params)

  recording = GradientTransformation(optimizer.init, update)
  local = program.local_config
  one = dataclasses.replace(local, train=dataclasses.replace(
      local.train, updates_per_iteration=1, presample_updates=1))
  start = torch.Generator(device=rs.action.device).manual_seed(SEED + 1)
  for group_or_none in (None, group):
    gen = torch.Generator(device=rs.action.device)
    gen.set_state(start.get_state())
    mu = make_multi_update_fn(net, recording, one, group=group_or_none)
    mu(TrainState(copy.deepcopy(ts.params), copy.deepcopy(ts.opt_state),
                  ts.step), copy.deepcopy(rs), gen)
  own, reduced = seen[0].cpu(), seen[1].cpu()
  parts = gathered(own)
  mean = torch.stack(parts).sum(0) / len(parts)
  check(torch.equal(mean, reduced),
        "the reduced gradient is the mean of the ranks' own gradients bit "
        f"for bit (max difference {float((mean - reduced).abs().max())})")
  return {"bit_identical": True, "own_grad_norm": float(own.norm()),
          "reduced_grad_norm": float(reduced.norm()),
          "ranks_differ": not torch.equal(parts[0], parts[-1])}


def update_ms_split(net, program, ts, rs, optimizer, group):
  """Host ms an update (synchronized) of PAR_SPLIT_UPDATES updates in one
  group on copies of the rank's state, with the learner's all-reduce over
  the data group and without it (this rank's own gradient): what the
  reduction costs an update where the learner runs."""
  import copy
  import dataclasses

  from muax_tpu_torch.train import TrainState, make_multi_update_fn
  local = program.local_config
  cfg = dataclasses.replace(local, train=dataclasses.replace(
      local.train, updates_per_iteration=PAR_SPLIT_UPDATES,
      presample_updates=PAR_SPLIT_UPDATES))
  out = {}
  for label, group_or_none in (("with_all_reduce", group),
                               ("without", None)):
    mu = make_multi_update_fn(net, optimizer, cfg, group=group_or_none)
    runs = []
    for _ in range(1 + TIMED_ITERATIONS):
      state = TrainState(copy.deepcopy(ts.params),
                         copy.deepcopy(ts.opt_state), ts.step)
      ring = copy.deepcopy(rs)
      gen = torch.Generator(device=rs.action.device).manual_seed(SEED)
      runs.append(host_ms(lambda: mu(state, ring, gen))[0])
    out[f"update_ms_{label}"] = sum(runs[1:]) / (TIMED_ITERATIONS
                                                 * PAR_SPLIT_UPDATES)
  return out


def reanalyze_across_ranks(program, ts, rs):
  """Phase 32 (d): ``program.reanalyze`` refreshes PAR_REANALYZE_SEGMENTS
  segments over the ranks, each on its own ring in one search launch: the
  segments summed over the ranks, the newest stamp the step, pi changed.
  The launch, at this rank's PAR_REANALYZE_SEGMENTS / PAR_RANKS x 20 roots,
  holds against the plain version on its own inputs by phase 21's rule
  (compare_search with tie_proof). Returns the figures and this process's
  launch counts (search, sampler, learner) just after the call, before the
  comparison's own launches."""
  pi_before = rs.pi.clone()
  before = rank_launches()[0]
  with SearchRecorder(keep=1) as rec:
    rs, metrics = program.reanalyze(ts, rs, SEED + 2)
    torch.cuda.synchronize()
  main_path = rank_launches()
  launches = main_path[0] - before
  roots = PAR_REANALYZE_SEGMENTS // PAR_RANKS * MAIN_STEPS
  check(rec.by_batch == {roots: 1}, f"reanalyze launched the search at "
        f"batches {rec.by_batch}, not once at {roots} roots")
  args, kwargs, out = rec.calls[0]
  cmp = compare_search(out, fused_reference(args, kwargs),
                       kwargs["num_simulations"],
                       tie_proof=tie_proof(args, kwargs))
  check(int(metrics["reanalyzed_segments"]) == PAR_REANALYZE_SEGMENTS,
        f"{float(metrics['reanalyzed_segments'])} segments reanalyzed, not "
        f"{PAR_REANALYZE_SEGMENTS}")
  check(int(rs.target_step.max()) == ts.step,
        f"newest target_step {int(rs.target_step.max())}, not {ts.step}")
  check(not torch.equal(pi_before, rs.pi), "reanalyze changed the ring's pi")
  check(launches == 1, f"{launches} search launches in one reanalyze call")
  return {"reanalyzed_segments": int(metrics["reanalyzed_segments"]),
          "value_shift": float(metrics["reanalyze_value_shift"]),
          "search_launches": launches, "roots": roots,
          "against_plain": dict(cmp, plan=mlp_plan_figures(
              rs.pi.device, args, kwargs))}, main_path


def rank_kernels_against_plain(device, net, program, ts, rs, carry):
  """Phase 32 (b)'s kernels at one rank's shapes, after its iterations:
  the MuZero search at the rank's envs, as phase 1 holds it (fresh weights
  from SEED, compare_search) and on the rank's own state (its parameters,
  its envs' observations, root noise from its generator; phase 21's rule,
  as a trained net meets near-ties), with the launch plan mlp_search_plan
  picks at that batch; the sampler at W = TRAIN_GROUP x the rank's batch
  on the rank's own ring (phase 4's rule); the learner on the first
  batch of those windows under the rank's parameters (phase 5's rule for
  the gradients and the losses; priorities_against_f64 for the
  priorities, as the rank's net is trained)."""
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn

  cfg = program.local_config
  envs, batch = cfg.train.num_envs, cfg.train.batch_size
  fresh = search_against_plain(device, "muzero", "mlp", 2, envs)
  gen = torch.Generator(device=device).manual_seed(SEED + 4)
  with torch.no_grad():
    root = make_root_fn(net)(ts.params, carry.obs)
  args = (root.embedding.contiguous(),
          fused.noised_root_logits(gen, root.prior_logits),
          root.value.contiguous(), fused.extract_search_weights(net,
                                                                ts.params))
  kwargs = dict(num_simulations=MAIN_SIMS, discount=cfg.train.discount,
                support_size=net.support_size, invalid_actions=None,
                max_depth=None)
  before = search_counts()[0]
  out = fused_cuda(args, kwargs)
  torch.cuda.synchronize()
  check(search_counts()[0] == before + 1, "the search launched once")
  own = compare_search(out, fused_reference(args, kwargs), MAIN_SIMS,
                       tie_proof=tie_proof(args, kwargs))
  sampler, (_, _, raw, lay) = sampler_launch_against_plain(
      device, gen, rs, TRAIN_GROUP * batch)
  learner = learner_launch_against_plain(
      device, loss_kwargs(cfg), net, ts.params,
      *learner_batch(raw, lay, batch), lay, trained=True)
  return {"envs": envs, "windows": TRAIN_GROUP * batch, "batch": batch,
          "search_fresh": fresh, "search_rank_state": dict(
              own, plan=mlp_plan_figures(device, args, kwargs)),
          "sampler": sampler, "learner": learner}


def go_tower(device, mesh):
  """Phase 32 (e): ``make_az_resnet(362, 256, 19)`` on GO_BATCH boards of
  19 x 19 x 17 planes, its channels split over ``mesh``'s model axis,
  against the replicated apply on the same weights (rtol 1e-4 / atol
  1e-5, TF32 off); the median ms of each apply."""
  from muax_tpu_torch.models import make_az_resnet
  from muax_tpu_torch.parallel import (make_model_parallel_apply,
                                       shard_az_params, sharded_fraction)
  net = make_az_resnet(GO_ACTIONS, channels=GO_CHANNELS,
                       num_blocks=GO_BLOCKS, device=device)
  params = net.init_params(GO_PLANES, torch.Generator().manual_seed(SEED))
  obs = torch.randn((GO_BATCH,) + GO_PLANES,
                    generator=torch.Generator().manual_seed(SEED + 3)).to(
                        device)
  sharded = shard_az_params(params, mesh)
  apply = make_model_parallel_apply(net, mesh)
  figures = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
             "backend": torch.distributed.get_backend(),
             "sharded_fraction": sharded_fraction(params, mesh),
             "conv_shard": list(sharded["blocks.0.conv_in.weight"].shape)}
  with torch.no_grad():
    ref = net.apply(params, obs)
    out = apply(sharded, obs)
    for name, a, b in zip(("logits", "value"), out, ref):
      check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
            f"model-parallel {name} against the replicated apply: "
            f"max diff {float((a - b).abs().max())}")
      figures[f"{name}_max_abs_err"] = float((a - b).abs().max())
    for label, fn in (("replicated_ms", lambda: net.apply(params, obs)),
                      ("model_parallel_ms", lambda: apply(sharded, obs))):
      runs = sorted(host_ms(fn)[0] for _ in range(GO_REPS))
      figures[label] = runs[len(runs) // 2]
  return figures


def nccl_world_of_one(rank, world_size, init_method):
  """Phase 32 (a), a rank in a process of its own: the sharded program at
  ``training_regime`` on a world of one through NCCL (two warm-up and
  three timed iterations), the NCCL all-reduce's ms at the flat gradient's
  size, and an update's ms with and without it."""
  import torch.distributed as dist
  from muax_tpu_torch.models.optimizers import flat_parameters
  from muax_tpu_torch.parallel import DATA_AXIS
  device = rank_setup()
  dist.init_process_group("nccl", init_method=init_method,
                          world_size=world_size, rank=rank)
  try:
    net, optimizer, program = sharded_program(device)
    ts, rs, _, figures = sharded_iterations(program, WARMUP_ITERATIONS,
                                            TIMED_ITERATIONS)
    figures["launches"] = rank_launches()
    figures["all_reduce_ms"] = all_reduce_ms(
        flat_parameters(ts.params).numel(), device)
    figures.update(update_ms_split(net, program, ts, rs, optimizer,
                                   program.mesh.get_group(DATA_AXIS)))
    return figures
  finally:
    dist.destroy_process_group()


def gloo_ranks_on_one_card(rank, world_size, init_method):
  """Phase 32 (b)-(e), one of PAR_RANKS ranks sharing the card through
  gloo: the sharded program (each rank 512 envs, batch 2048, ring 1024),
  its launches and the ranks' bit-identical state after every iteration,
  reanalyze across the ranks, each kernel against its plain version at the
  rank's shapes, the gloo all-reduce's ms and an update's ms
  with and without it, the reduction's meaning, and the channel-sharded Go
  tower on a (1, PAR_RANKS) mesh."""
  import torch.distributed as dist
  from muax_tpu_torch.models.optimizers import flat_parameters
  from muax_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh
  device = rank_setup()
  dist.init_process_group("gloo", init_method=init_method,
                          world_size=world_size, rank=rank)
  try:
    net, optimizer, program = sharded_program(
        device, reanalyze_segments=PAR_REANALYZE_SEGMENTS)
    ts, rs, carry, figures = sharded_iterations(
        program, 1, PAR_GLOO_ITERATIONS - 1, state_check=True)
    figures["reanalyze"], figures["launches"] = reanalyze_across_ranks(
        program, ts, rs)
    figures["kernels"] = rank_kernels_against_plain(device, net, program, ts,
                                                    rs, carry)
    figures["all_reduce_ms"] = all_reduce_ms(
        flat_parameters(ts.params).numel(), device)
    group = program.mesh.get_group(DATA_AXIS)
    figures.update(update_ms_split(net, program, ts, rs, optimizer, group))
    figures["reduction"] = reduction_meaning(net, program, ts, rs, optimizer,
                                             group)
    figures["go_tower"] = go_tower(device, make_mesh(
        (1, world_size), (DATA_AXIS, MODEL_AXIS), device="cuda"))
    return figures
  finally:
    dist.destroy_process_group()


def parallel_phase(phase6_ms=None):
  """Phase 32: the parallel layer. (a) a world of one through NCCL in a
  process of its own, then (b)-(e) PAR_RANKS ranks on the one card through
  gloo, each group spawned with a file rendezvous and killed past
  PAR_TIMEOUT_S. Returns the figures and the launches (search, sampler,
  learner) summed over every rank's main path."""
  from muax_tpu_torch.parallel.launch import spawn_group
  nccl = spawn_group(nccl_world_of_one, 1, timeout=PAR_TIMEOUT_S)[0]
  gloo = spawn_group(gloo_ranks_on_one_card, PAR_RANKS,
                     timeout=PAR_TIMEOUT_S)
  pair_ms = max(r["iteration_ms"] for r in gloo)
  return {
      "a_nccl_world_of_one": nccl,
      "phase_6_iteration_ms": phase6_ms,
      "b_gloo_ranks_on_one_card": {
          "pair_iteration_ms": pair_ms,
          "pair_env_steps_per_s": TRAIN_ENVS * MAIN_STEPS / (pair_ms / 1e3),
          "ranks": [{k: v for k, v in r.items()
                     if k not in ("reduction", "reanalyze", "go_tower",
                                  "kernels")}
                    for r in gloo]},
      "b_kernels_against_plain": [r["kernels"] for r in gloo],
      "c_reduction": [r["reduction"] for r in gloo],
      "d_reanalyze": [r["reanalyze"] for r in gloo],
      "e_go_tower": [r["go_tower"] for r in gloo],
      "launches": [nccl["launches"][i] + sum(r["launches"][i] for r in gloo)
                   for i in range(3)],
  }


# ---- phase 33: Stochastic MuZero with towers past shared memory (C.4) ----

def wide_smz_launch(net, params, obs, legal, gen):
  """One Stochastic MuZero launch of phase 33 on the roots of ``obs``
  under the legal masks ``legal``: (args, kwargs) as ``fused_smz_search``
  takes them, the root prior noised as the policy noises it."""
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_smz_fns

  with torch.no_grad():
    root = make_smz_fns(net, SMZ_WIDE_DISCOUNT)[0](params, obs)
  invalid = (1.0 - legal).contiguous()
  args = (root.embedding.contiguous(),
          fused.noised_root_logits(gen, root.prior_logits, invalid),
          root.value.contiguous(),
          fused.extract_smz_fused_weights(net, params))
  kwargs = dict(num_simulations=SMZ_SIMS, support_size=net.support_size,
                discount=SMZ_WIDE_DISCOUNT, invalid_actions=invalid,
                max_depth=None)
  return args, kwargs


def smz_wide_l2_bytes(plan, lay, batch, sims):
  """The tower bytes a wide SMZ launch reads from L2 (a model, not a
  measured count): each tile stages every rank's prefix (biases, one-hot
  rows, resident parts) once, and streams the rest of every rank's pack
  once a simulation."""
  tiles = -(-batch // plan.tile)
  staged = plan.cluster * lay.res_floats
  streamed = plan.cluster * (lay.rank_floats - lay.res_floats)
  return 4 * tiles * (staged + sims * streamed)


def smz_forced(plan, args, kwargs):
  """``fused_smz_search`` on ``plan`` in place of the search's own."""
  from muax_tpu_torch.search import fused
  chosen = fused.smz_launch_plan
  fused.smz_launch_plan = lambda *a, **k: plan
  try:
    return fused.fused_smz_search(*args, **kwargs)
  finally:
    fused.smz_launch_plan = chosen


def wide_smz_kernel(plan, args, kwargs, weights):
  """The tile kernel of phase 33 on one plan: two launches (bit-identical,
  each counted once, also as wide), the outputs against the plain version
  by ``compare_masked_smz``, the ms, and the tower bytes it reads from L2
  (a model per tile and simulation)."""
  from muax_tpu_torch.search import fused
  before, wide_before = search_counts(), fused.smz_wide_launches
  out = smz_forced(plan, args, kwargs)
  again = smz_forced(plan, args, kwargs)
  torch.cuda.synchronize()
  got = tuple(a - b for a, b in zip(search_counts(), before))
  check(got == (0, 0, 0, 0, 2)
        and fused.smz_wide_launches - wide_before == 2,
        f"two SMZ launches of the tile kernel, not {got}")
  check(all(torch.equal(a, b) for a, b in zip(out, again)),
        "a repeated launch gives the same bits")
  check(bool(torch.isfinite(out[2]).all()), "finite q")
  _, fig = compare_masked_smz(out, args, kwargs)
  fig["ms"] = time_ms(lambda: smz_forced(plan, args, kwargs), SMZ_WIDE_REPS)
  lay = fused.smz_wide_plan_layout(plan, 4, 32, 64, 601, SMZ_SIMS, SMZ_SIMS,
                                   *fused._smz_widths(weights))
  fig["weight_bytes_from_l2"] = smz_wide_l2_bytes(plan, lay, args[0].shape[0],
                                                  SMZ_SIMS)
  fig["plan"] = dict(plan._asdict(), parts=len(lay.parts),
                     streamed_pieces_a_sim=lay.n_stream)
  return fig


def wide_smz_phase(device):
  """Phase 33: the Stochastic MuZero search at examples/run_2048.py's
  widths, towers past a block's shared memory, on the roots of real boards
  of the native pool under their legal masks, at SMZ_WIDE_ENVS roots x
  SMZ_SIMS simulations. At each batch the plan takes the tile kernel
  (``fused_smz_wide_kernel``, tiles of environments sharing every tower
  read), held by ``wide_smz_kernel``; the plain version's ms, and the
  bounds of the expansions this run makes: ``bound_ms`` at the 3xTF32
  rate its products run at, ``bound_f32_fma_ms`` at the f32 rate. Then
  ``make_policy_fn`` with ``policy="stochastic"`` over the same net at
  each batch, one launch of the tile kernel a call and nothing else."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig
  from muax_tpu_torch.models import make_stochastic_mlp_networks
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.actor import make_policy_fn

  net = make_stochastic_mlp_networks(4, device=device, **SMZ_WIDE_NET)
  params = net.init_params((4, 4), torch.Generator().manual_seed(SEED))
  obs, legal = host_boards(device, max(SMZ_WIDE_ENVS), HOST_BOARD_MOVES)
  gen = torch.Generator(device=device).manual_seed(SEED)
  figures = {}
  for B in SMZ_WIDE_ENVS:
    args, kwargs = wide_smz_launch(net, params, obs[:B].contiguous(),
                                   legal[:B].contiguous(), gen)
    check(bool((kwargs["invalid_actions"] > 0).any()),
          "the boards' masks have illegal moves")
    weights = args[3]
    n = weights.flat().numel()
    check(n == SMZ_WIDE_FLOATS, f"{n} floats of towers")
    plan = fused.smz_launch_plan(args[0], weights, **kwargs)
    tile = fused.smz_wide_plan(
        B, 4, 32, 64, 601, SMZ_SIMS, SMZ_SIMS, *fused._smz_widths(weights),
        fused.device_limits(device), fused.smz_wide_active_clusters(
            device.index))
    check(plan == tile, f"the plan at {B} boards takes the tile kernel: "
          f"{plan}")
    fig = wide_smz_kernel(plan, args, kwargs, weights)
    fig["plain_ms"] = once_ms(lambda: smz_reference(args, kwargs))
    fig.update(smz_bound_ms(args, kwargs, tensor_cores=True))
    figures[f"envs_{B}"] = fig

  config = MuZeroConfig(search=SearchConfig(policy="stochastic",
                                            num_simulations=SMZ_SIMS))
  policy_fn = make_policy_fn(net, config, SMZ_WIDE_DISCOUNT, device=device)
  wide_launches = 0
  for B in SMZ_WIDE_ENVS:
    invalid = (1.0 - legal[:B]).contiguous()
    roots = obs[:B].contiguous()
    reset_counts()
    for _ in range(SMZ_WIDE_POLICY_CALLS):
      action, pi, value = policy_fn(params, gen, roots, 1.0, invalid)
    torch.cuda.synchronize()
    launches = search_counts()
    check(launches == (0, 0, 0, 0, SMZ_WIDE_POLICY_CALLS)
          and fused.smz_wide_launches == SMZ_WIDE_POLICY_CALLS
          and all_kernel_launches() == SMZ_WIDE_POLICY_CALLS,
          f"the stochastic policy at {B} boards launched {launches}, "
          f"{fused.smz_wide_launches} of them on the tile kernel")
    wide_launches += fused.smz_wide_launches
    check(bool((legal[:B].gather(1, action.long()[:, None]) == 1).all()),
          "every action legal")
    check(bool(torch.allclose(pi.sum(-1), torch.ones_like(value)))
          and float(pi[invalid > 0].abs().max()) == 0.0,
          "pi sums to 1 and misses illegal moves")
    figures[f"policy_{B}"] = {
        "calls": SMZ_WIDE_POLICY_CALLS,
        "smz_wide_launches": fused.smz_wide_launches,
        "ms": time_ms(lambda: policy_fn(params, gen, roots, 1.0, invalid),
                      SMZ_WIDE_REPS)}
  return figures, wide_launches


# ---- phase 34: the example scripts on the card -------------------------

def fit_schedule(config, iterations):
  """What ``fit`` runs for ``iterations`` iterations of ``config``: (the
  warm-up rollouts, the learner groups, the updates), the updates held by
  the samples-per-insert gate where the config has one, as fit computes
  it."""
  import numpy as np
  tcfg = config.train
  warm = max(1, config.replay.min_fill // tcfg.num_envs)
  per_iter = tcfg.num_envs * tcfg.collect_steps
  n = tcfg.updates_per_iteration
  groups = n // math.gcd(n, max(1, tcfg.presample_updates))
  inserted, sampled, updates = warm * per_iter, 0, 0
  for _ in range(iterations):
    inserted += per_iter
    allowed = n
    if tcfg.samples_per_insert is not None:
      budget = tcfg.samples_per_insert * inserted * (1.0 + tcfg.spi_tolerance)
      allowed = int(np.clip((budget - sampled) // tcfg.batch_size, 0, n))
      sampled += allowed * tcfg.batch_size
    updates += allowed
  return warm, groups * iterations, updates


def run_main(module, argv):
  """``module.main(argv)`` on the card with the launch counts set to 0
  just before and read just after: (its return, its standard output, the
  seconds it took, the search recorder, the first sampler and learner
  launches with their inputs (``FirstCall``), the config ``fit`` was
  called with (None where the script calls no fit), the steps of every
  ``AutoResetWrapper`` and host pool by batch size, the launches of each
  search mode, the sampler's and the learner's)."""
  import contextlib
  import copy
  import io

  from muax_tpu_torch.envs.base import AutoResetWrapper
  from muax_tpu_torch.envs.gym_adapter import HostPool
  from muax_tpu_torch.envs.native2048 import Native2048Pool
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.train import learner

  # Native2048Pool steps on its own, not through HostPool.step.
  steps, fit_config = {}, []
  stepping = (AutoResetWrapper, HostPool, Native2048Pool)
  real = [cls.step for cls in stepping]

  def counting(step):
    def counted(self, carry, action, generator):
      batch = action.shape[0]
      steps[batch] = steps.get(batch, 0) + 1
      return step(self, carry, action, generator)
    return counted

  real_fit = getattr(module, "fit", None)

  def fitting(env, networks, config=None, *args, **kwargs):
    fit_config.append(config)
    return real_fit(env, networks, config, *args, **kwargs)

  def ring_copy(call):
    (state, *rest), kwargs = call
    return (copy.deepcopy(state), *copied(tuple(rest))), kwargs

  def params_copy(call):
    (params, *rest), kwargs = call
    return (copy.deepcopy(params), *copied(tuple(rest))), kwargs

  out = io.StringIO()
  for cls, step in zip(stepping, real):
    cls.step = counting(step)
  if real_fit is not None:
    module.fit = fitting
  try:
    reset_counts()
    t0 = time.perf_counter()
    with SearchRecorder() as rec, FirstCall(
        fused_sampler, "_sample_cuda", ring_copy) as sampled, FirstCall(
            learner, "fused_muzero_grad_raw", params_copy) as learned, \
        contextlib.redirect_stdout(out):
      ret = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
  finally:
    for cls, step in zip(stepping, real):
      cls.step = step
    if real_fit is not None:
      module.fit = real_fit
  counts = {"search_by_mode": search_counts(),
            "sampler": fused_sampler.launches,
            "learner": fused_learner.launches
            + fused_learner.categorical_launches}
  return (ret, out.getvalue(), seconds, rec, sampled.kept, learned.kept,
          fit_config[0] if fit_config else None, steps, counts)


def example_launches_against_plain(rec, sampled, learned):
  """Phase 34's check of what the kernels computed inside a fit-based
  script: the first search launch at each batch size (the training
  rollout's and the greedy evaluation's) against the plain version on its
  own inputs (phase 21's rule: compare_search with tie_proof, as a trained
  net meets near-ties), the first sampler launch against the plain version
  on a copy of the ring as it was (phase 4's rule: compare_raw), and the
  first learner launch against autograd over muzero_loss under the
  parameters and loss settings it ran with (phase 5's rule: gradients
  rtol 2e-4 / atol 1e-6, metrics_close)."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler

  figures = {}
  for batch, (args, kwargs, out) in sorted(rec.first.items()):
    figures[f"search_{batch}"] = compare_search(
        out, fused_reference(args, kwargs), kwargs["num_simulations"],
        invalid=kwargs.get("invalid_actions"),
        tie_proof=tie_proof(args, kwargs))
  args, kwargs, (raw, lay) = sampled
  ref, _ = fused_sampler.fused_sample_group_reference(*args, **kwargs)
  figures["sampler"] = dict(compare_raw(raw, ref, lay), windows=raw.shape[1])
  args, kwargs, (grads, metrics) = learned
  ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
      *args[:5], **kwargs)
  err, used = grads_close(grads, ref_grads, 2e-4, 1e-6)
  metrics_close(metrics, ref_metrics)
  figures["learner"] = {"batch": args[1].shape[1], "max_abs_err": err,
                        "tolerance_used": used}
  return figures


def fit_example(name, argv, kernels, iterations):
  """One fit-based example (``name``) at ``argv``. ``kernels`` pins what
  fit's status line must say: search=on learner=on sampler=on (True), or
  all three OFF (False: the conv family's scripts). Its launches are held
  to fit's schedule for the config the script passed to fit: with
  ``kernels`` the MLP MuZero search once a step of the training batch
  ((warm-up + iterations) x collect steps) and once a step of the
  evaluation's batch (every step of an ``AutoResetWrapper`` at that batch),
  the sampler once a learner group and the learner once an update, and
  each kernel's first launch held against its plain version
  (``example_launches_against_plain``); else none. Returns the launches,
  the comparisons and the iteration's ms."""
  import importlib
  module = importlib.import_module(f"muax_tpu_torch.examples.{name}")
  (ret, text, seconds, rec, sampled, learned, config, steps,
   counts) = run_main(module, argv)
  tcfg = config.train
  status = next(line for line in text.splitlines() if "fused:" in line)
  for part in ("search", "learner", "sampler"):
    check((f"{part}=on" in status) == kernels,
          f"{name}: {part} {'on' if kernels else 'OFF'} in {status!r}")
  warm, groups, updates = fit_schedule(config, iterations)
  rollout_steps = (warm + iterations) * tcfg.collect_steps
  want_search = {}
  if kernels:
    want_search = {b: n for b, n in steps.items() if b != tcfg.num_envs}
    want_search[tcfg.num_envs] = rollout_steps
  check(rec.by_batch == want_search, f"{name}: search launches by batch "
        f"{rec.by_batch}, not {want_search}")
  check(steps.get(tcfg.num_envs) == rollout_steps,
        f"{name}: env steps by batch {steps}, not {rollout_steps} of "
        f"{tcfg.num_envs}")
  by_mode = [0] * 5
  by_mode[search_mode(config.search.policy, "mlp")] = sum(
      want_search.values())
  want = {"search_by_mode": tuple(by_mode),
          "sampler": groups if kernels else 0,
          "learner": updates if kernels else 0}
  check(counts == want, f"{name}: launches {counts}, not {want}")
  _, results = ret
  history = results["history"]
  check(len(history) >= 1, f"{name}: an iteration logged")
  for row in history:
    for k, v in row.items():
      check(math.isfinite(v), f"{name}: fit metric {k} = {v} is finite")
  first = history[0]
  figures = {"status": status, "launches": dict(counts, search_by_batch={
      str(b): n for b, n in rec.by_batch.items()}),
             "main_s": seconds,
             "iteration_1_ms": tcfg.num_envs * tcfg.collect_steps
             / first["env_steps_per_s"] * 1e3,
             "test_G": first.get("test_G"), "loss": first["loss"]}
  if kernels:
    figures["against_plain"] = example_launches_against_plain(
        rec, sampled, learned)
  return figures


def kernel_free_example(name, argv, iterations):
  """One example of the generic engine (AlphaZero, the MCTS agents): its
  main at ``argv`` launches none of the port's kernels; ms an
  iteration."""
  import importlib
  module = importlib.import_module(f"muax_tpu_torch.examples.{name}")
  ret, _, seconds, rec, *_, counts = run_main(module, argv)
  check(all_kernel_launches() == 0 and not rec.by_batch,
        f"{name}: launched {counts}")
  return ret, {"launches": 0, "main_s": seconds,
               "ms_per_iteration": seconds / iterations * 1e3}


def examples_phase(root):
  """Phase 34: each example script's ``main`` on the card (its default
  ``--device``) at its default widths for EXAMPLE_ITERATIONS iterations
  (the generic-engine scripts at EXAMPLE_GENERIC_SIMS simulations), each
  kernel's launches exact and, in the scripts that run kernels, each
  kernel's first launch held against its plain version (``fit_example``);
  the LunarLander script where gymnasium with Box2D imports, else a line
  that says it is not run."""
  import importlib.util
  import tempfile

  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.search import fused

  n = str(EXAMPLE_ITERATIONS)
  sims = ["--num_simulations", str(EXAMPLE_GENERIC_SIMS)]
  out = {}
  os.makedirs(os.path.join(root, "build"), exist_ok=True)
  with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
    out["run_cartpole"] = fit_example(
        "run_cartpole",
        ["--num_iterations", n, "--model_dir", os.path.join(d, "cartpole")],
        True, EXAMPLE_ITERATIONS)
    out["run_acme_regime"] = fit_example(
        "run_acme_regime", ["--num_iterations", n], True, EXAMPLE_ITERATIONS)
    # run_2048: the native pool and the wide towers, every search launch
    # the tile kernel's and every update the learner's cluster pass (the
    # counts as fit_example's run left them).
    out["run_2048"] = fit_example(
        "run_2048",
        ["--num_iterations", n, "--model_dir", os.path.join(d, "2048")],
        True, EXAMPLE_ITERATIONS)
    got = out["run_2048"]["launches"]
    check((fused.wide_launches, fused_learner.wide_launches)
          == (got["search_by_mode"][0], got["learner"]),
          f"run_2048: the wide kernels' launches {got}")
    out["run_pixel"] = fit_example(
        "run_pixel",
        ["--num_iterations", n, "--model_dir", os.path.join(d, "pixel")]
        + sims, False, EXAMPLE_ITERATIONS)
    if (importlib.util.find_spec("gymnasium") is None
        or importlib.util.find_spec("Box2D") is None):
      out["run_lunarlander"] = ("not run on this machine: it has no "
                                "gymnasium with Box2D")
    else:
      out["run_lunarlander"] = fit_example(
          "run_lunarlander",
          ["--num_iterations", n, "--model_dir",
           os.path.join(d, "lunarlander")], True, EXAMPLE_ITERATIONS)
  out["run_atari --fake"] = fit_example(
      "run_atari", ["--fake", "--iterations", n] + sims, False,
      EXAMPLE_ITERATIONS)
  rate, _ = kernel_free_example("run_atari", ["--fake", "--measure_pool"],
                                1)
  out["run_atari --fake --measure_pool"] = {"env_steps_per_s": rate}
  for name in ("run_tictactoe_alphazero", "run_connect4"):
    curve, out[name] = kernel_free_example(name, ["--iterations", n] + sims,
                                           EXAMPLE_ITERATIONS)
    check(curve == [], f"{name}: no evaluation within {n} iterations")
  for mode in ("--simulator", "--nosimulator"):
    (loss, rate, model), fig = kernel_free_example(
        "run_mcts", [mode, "--iterations", n] + sims, EXAMPLE_ITERATIONS)
    check(math.isfinite(loss) and 0.0 <= rate <= 1.0,
          f"run_mcts {mode}: loss {loss}, catch rate {rate}")
    out[f"run_mcts {mode}"] = dict(fig, loss=loss, catch_rate=rate)
  return out


def run(device):
  from muax_tpu_torch import _build
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused

  card = card_line()
  print(card)
  t_start = time.perf_counter()
  t0 = time.perf_counter()
  logs = _build.build_all()
  build_s = time.perf_counter() - t0
  ptxas = ptxas_figures(logs)
  for label, fig in ptxas.items():
    print(f"  ptxas {label}: {json.dumps(fig)}")
  print("phase 0 build: " + json.dumps({
      "seconds": build_s, "sources": list(logs), "torch": torch.__version__,
      "cuda": torch.version.cuda}))

  t0 = time.perf_counter()
  mlp = dict(pred_layers=(16,), dyn_layers=(16,))
  mlp_edge = dict(pred_layers=(16, 16), dyn_layers=(16, 16))
  main_cmp = search_against_plain(device, "muzero", "mlp", 2, MAIN_ENVS, mlp)
  main_groups = {f"G={g}": search_against_plain(
      device, "muzero", "mlp", 2, MAIN_ENVS, mlp, group=g)
                 for g in fused.MLP_GROUPS}
  print(f"phase 1 kernel vs plain, B={MAIN_ENVS} sims={MAIN_SIMS} A=2 "
        f"E={EMBED} S={SUPPORT} H=(16,): {json.dumps(main_cmp)}; each "
        f"lane-group size: {json.dumps(main_groups)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  edge_cmp = search_against_plain(device, "muzero", "mlp", 4, EDGE_ENVS,
                                  mlp_edge, with_invalid=True, max_depth=2)
  print(f"phase 2 kernel vs plain, B={EDGE_ENVS} sims={MAIN_SIMS} A=4 with "
        f"one invalid action, max_depth=2, H=(16, 16): "
        f"{json.dumps(edge_cmp)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  launches, figures, (args, kwargs) = drive_main_path(device)
  figures.update(mlp_search_figures(device, args, kwargs, False))
  bound_ms, bound_by = figures["bound_ms"], figures["bound_by"]
  print(f"phase 3 rollout, {MAIN_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps: {json.dumps(figures)} "
        f"({time.perf_counter() - t0:.1f} s)")

  # ---- training: the ring, the sampler, the learner, the iteration, fit --
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler

  t0 = time.perf_counter()
  t = training_setup(device)
  sampler_main, sampler_edge, (seg_idx, gumbel, raw, lay) = (
      sampler_against_plain(device, t))
  print(f"phase 4 sampler vs plain, C={TRAIN_CAPACITY} L={MAIN_STEPS} "
        f"K={TRAIN_UNROLL} W={TRAIN_GROUP * TRAIN_BATCH} on a ring of "
        f"rollouts: {json.dumps(sampler_main)}; W=1000 on a half-filled "
        f"ring with dones: {json.dumps(sampler_edge)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  learner_main, learner_edge, learner_notebook, learner_wide = (
      learner_against_plain(device, t, raw, lay))
  print(f"phase 5 learner vs plain, B={TRAIN_BATCH} on phase 4's windows: "
        f"{json.dumps(learner_main)}; B=1000 A=4 H=(16, 16) S=10 with "
        f"masks: {json.dumps(learner_edge)}; the notebook towers, "
        f"B={NOTEBOOK_BATCH} K={NOTEBOOK_K} H=(64, 64, 16) E=10, arena in "
        f"the scratch: {json.dumps(learner_notebook)}; B=300 H=(128,): "
        f"{json.dumps(learner_wide)}; repeated launches "
        f"bit-identical ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  train_launches, train = drive_training(device, t)
  W = TRAIN_GROUP * TRAIN_BATCH
  seg_idx = fused_sampler.draw_segments(t.rs, t.gen, W)
  gumbel = gumbel_noise(t.gen, (MAIN_STEPS, W), device)
  sample_args = (t.rs, seg_idx, gumbel, TRAIN_UNROLL)
  train["sampler_ms"] = time_ms(
      lambda: fused_sampler.fused_sample_group(*sample_args), 20)
  train["plain_sampler_ms"] = time_ms(
      lambda: fused_sampler.fused_sample_group_reference(*sample_args), 3)
  raw, lay = fused_sampler.fused_sample_group(*sample_args)
  raw_b, coef = learner_batch(raw, lay, TRAIN_BATCH)
  lw = fused_learner.extract_learner_weights(t.net, t.ts.params)
  kw = loss_kwargs(t.config)
  learn_args = (t.ts.params, raw_b, coef, lay, t.net)
  # The kernel's wrapper alone (the tile pass and the finish pass), without
  # the loss metrics that fused_muzero_grad_raw derives after it; and each
  # kernel of the launch on the device, with the plan.
  def learn():
    return fused_learner._grad_cuda(lw, raw_b, coef, lay,
                                    l2_coef=kw["l2_coef"],
                                    gradient_scale=kw["gradient_scale"])

  train["learner_kernel_ms"] = time_ms(learn, 50)
  train["learner_by_kernel_ms"] = kernel_device_ms(learn, 20)
  plan = fused_learner.mlp_learner_plan(TRAIN_BATCH, lay.K, lw,
                                        fused.device_limits(device))
  per_sm = fused_learner.learner_blocks_per_sm(plan, device)
  train["learner_plan"] = plan._asdict()
  train["learner_theoretical_warps_per_sm"] = min(
      per_sm, -(-plan.blocks // torch.cuda.get_device_properties(
          device).multi_processor_count)) * fused_learner.LEARNER_THREADS // 32
  train["plain_learner_ms"] = time_ms(
      lambda: fused_learner.fused_muzero_grad_raw_reference(*learn_args,
                                                            **kw), 5)
  sampler_bound, sampler_by = sampler_bound_ms(lay, W, MAIN_STEPS)
  learner_bound, learner_by = learner_bound_ms(t.net, lay, TRAIN_BATCH,
                                               lw.flat.numel())
  train.update(sampler_bound_ms=sampler_bound,
               learner_bound_ms=learner_bound)
  print(f"phase 6 training iteration, {TRAIN_ENVS} envs x {MAIN_SIMS} sims "
        f"x {MAIN_STEPS} steps, {TRAIN_UPDATES} updates of {TRAIN_BATCH} in "
        f"groups of {TRAIN_GROUP}: {json.dumps(train)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  fit_figures = drive_fit(device, os.path.dirname(os.path.abspath(__file__)))
  print(f"phase 7 fit, 3 iterations, eval_every=2, checkpoint_every=2: "
        f"{json.dumps(fit_figures)} ({time.perf_counter() - t0:.1f} s)")

  # ---- Gumbel MuZero and the generic engine ------------------------------
  t0 = time.perf_counter()
  gumbel_main = search_against_plain(device, "gumbel", "mlp", 2, MAIN_ENVS,
                                     mlp)
  gumbel_edge = search_against_plain(device, "gumbel", "mlp", 4, EDGE_ENVS,
                                     mlp_edge, with_invalid=True,
                                     max_depth=2)
  gumbel_groups = {f"G={g}": search_against_plain(
      device, "gumbel", "mlp", 2, MAIN_ENVS, mlp, group=g)
                   for g in fused.MLP_GROUPS}
  print(f"phase 8 Gumbel kernel vs plain, B={MAIN_ENVS} sims={MAIN_SIMS} "
        f"A=2 max_considered=16 H=(16,): {json.dumps(gumbel_main)}; "
        f"B={EDGE_ENVS} A=4 with one invalid action (3 considered), "
        f"max_depth=2, H=(16, 16): {json.dumps(gumbel_edge)}; each "
        f"lane-group size at B={MAIN_ENVS}: {json.dumps(gumbel_groups)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  _, gumbel_figures, (args, kwargs) = drive_main_path(device, "gumbel")
  gumbel_figures.update(mlp_search_figures(device, args, kwargs, True))
  gumbel_bound = gumbel_figures["bound_ms"]
  gumbel_by = gumbel_figures["bound_by"]
  print(f"phase 9 Gumbel rollout, {MAIN_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps: {json.dumps(gumbel_figures)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  tg = training_setup(device, "gumbel")
  fill_ring(tg)
  gumbel_train_launches, gumbel_train = drive_training(device, tg)
  print(f"phase 10 Gumbel training iteration, {TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims x {MAIN_STEPS} steps, {TRAIN_UPDATES} updates of "
        f"{TRAIN_BATCH} in groups of {TRAIN_GROUP}: {json.dumps(gumbel_train)}"
        f" ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  generic = generic_engine(device)
  print(f"phase 11 generic engine (search.fused=False), {TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims, one policy step: {json.dumps(generic)} "
        f"({time.perf_counter() - t0:.1f} s)")

  # ---- the acme categorical family ---------------------------------------
  t0 = time.perf_counter()
  cat_cmp = {}
  for policy in ("muzero", "gumbel"):
    cat_cmp[policy] = {
        "main": search_against_plain(device, policy, "categorical", 2,
                                     CAT_ENVS, CAT_NET),
        "main_512": search_against_plain(device, policy, "categorical", 2,
                                         CAT_SEARCH_SMALL_ENVS, CAT_NET),
        "edge": search_against_plain(device, policy, "categorical", 3,
                                     EDGE_ENVS, CAT_EDGE_NET,
                                     with_invalid=True, max_depth=2),
        "trees_in_scratch": search_against_plain(
            device, policy, "categorical", SCRATCH_TREE_ACTIONS, CAT_ENVS,
            CAT_NET, timed=True)}
  widths = [CAT_NET["num_bins"], *CAT_NET["layer_sizes"] * 2]
  plan = fused.tiled_plan(CAT_ENVS, SCRATCH_TREE_ACTIONS,
                          CAT_NET["embedding_dim"], MAIN_SIMS, widths,
                          fused.device_limits(device))
  check(not plan.smem_trees, f"A={SCRATCH_TREE_ACTIONS} keeps its trees in "
        "the device scratch")
  print(f"phase 12 categorical search kernel vs plain, B={CAT_ENVS} and "
        f"B={CAT_SEARCH_SMALL_ENVS} sims={MAIN_SIMS} A=2 E=64 H=(256, 256, "
        f"256) 51 bins +-150; B={EDGE_ENVS} A=3 with one invalid action, "
        f"max_depth=2, H=(48, 32), 21 bins; B={CAT_ENVS} "
        f"A={SCRATCH_TREE_ACTIONS}, trees in the device scratch ({plan}), "
        f"timed: "
        f"{json.dumps(cat_cmp)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  cat_roll = {}
  for policy in ("muzero", "gumbel"):
    _, cat_figures, (args, kwargs) = drive_main_path(device, policy,
                                                     "categorical")
    gumbel = policy == "gumbel"
    plain = (fused.fused_gumbel_search_reference if gumbel
             else fused.fused_muzero_search_reference)
    cat_figures["search_ms"] = time_ms(
        lambda: fused._fused_search_cuda(*args, **kwargs), 5)
    cat_figures["plain_search_ms"] = time_ms(lambda: plain(*args, **kwargs),
                                             1)
    cat_figures["bound_ms"], cat_figures["bound_by"] = search_bound_ms(
        CAT_ENVS, MAIN_SIMS, args[3], False, gumbel=gumbel,
        peak=PEAK_3XTF32_FLOPS)
    cat_figures["bound_f32_fma_ms"] = search_bound_ms(
        CAT_ENVS, MAIN_SIMS, args[3], False, gumbel=gumbel)[0]
    cat_figures["macs_per_expansion"] = search_macs(args[3])
    # The same kernel at categorical_training's envs, on the first 512 of
    # the rollout's roots.
    small = CAT_SEARCH_SMALL_ENVS
    args_s = tuple(a[:small].contiguous() for a in args[:3]) + (args[3],)
    kwargs_s = dict(kwargs)
    if gumbel:
      kwargs_s["root_score"] = kwargs["root_score"][:small].contiguous()
      kwargs_s["schedule"] = kwargs["schedule"][:small].contiguous()
    cat_figures["search_ms_512"] = time_ms(
        lambda: fused._fused_search_cuda(*args_s, **kwargs_s), 5)
    cat_figures["plain_search_ms_512"] = time_ms(
        lambda: plain(*args_s, **kwargs_s), 1)
    cat_figures["bound_ms_512"] = search_bound_ms(
        small, MAIN_SIMS, args[3], False, gumbel=gumbel,
        peak=PEAK_3XTF32_FLOPS)[0]
    cat_figures["bound_f32_fma_ms_512"] = search_bound_ms(
        small, MAIN_SIMS, args[3], False, gumbel=gumbel)[0]
    cat_roll[policy] = cat_figures
  print(f"phase 13 categorical rollout, {CAT_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps, each policy, and the kernel at "
        f"{CAT_SEARCH_SMALL_ENVS} envs: {json.dumps(cat_roll)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  tc = training_setup(device, "muzero", "categorical")
  fill_ring(tc)
  W = TRAIN_PRESAMPLE * CAT_BATCH
  seg_idx = fused_sampler.draw_segments(tc.rs, tc.gen, W)
  gumbel = gumbel_noise(tc.gen, (MAIN_STEPS, W), device)
  raw, lay = fused_sampler.fused_sample_group(tc.rs, seg_idx, gumbel,
                                              TRAIN_UNROLL)
  cat_learn_main, cat_learn_edge = categorical_learner_against_plain(
      device, tc, raw, lay)
  raw_b, coef = learner_batch(raw, lay, CAT_BATCH)
  spec = fused_learner.extract_categorical_learner_spec(tc.net, tc.ts.params)
  kw = loss_kwargs(tc.config)
  def learn():
    return fused_learner._grad_cuda(spec, raw_b, coef, lay,
                                    l2_coef=kw["l2_coef"],
                                    gradient_scale=kw["gradient_scale"])

  # The wrapper launches both kernels (the per-tile pass and the
  # weight-gradient pass): its time is their sum.
  cat_learner = {
      "main": cat_learn_main, "edge": cat_learn_edge,
      "kernel_ms": time_ms(learn, 10),
      "by_kernel_ms": kernel_device_ms(learn, 10),
      "plain_ms": time_ms(
          lambda: fused_learner.fused_muzero_grad_raw_reference(
              tc.ts.params, raw_b, coef, lay, tc.net, **kw), 3),
      "n_weights": spec.flat.numel()}
  cat_learner["bound_ms"], cat_learner["bound_by"] = learner_bound_ms(
      tc.net, lay, CAT_BATCH, spec.flat.numel(), peak=PEAK_3XTF32_FLOPS)
  cat_learner["bound_f32_fma_ms"] = learner_bound_ms(
      tc.net, lay, CAT_BATCH, spec.flat.numel())[0]
  print(f"phase 14 categorical learner vs plain, B={CAT_BATCH} on sampled "
        f"windows (bench widths), B=300 A=3 H=(48, 32) with masks; repeated "
        f"launches bit-identical: {json.dumps(cat_learner)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  cat_train_launches, cat_train = drive_training(device, tc)
  print(f"phase 15 categorical training iteration, {CAT_TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims x {MAIN_STEPS} steps, {CAT_UPDATES} updates of "
        f"{CAT_BATCH} in groups of {tc.group}: {json.dumps(cat_train)} "
        f"({time.perf_counter() - t0:.1f} s)")

  # ---- Stochastic MuZero -------------------------------------------------
  t0 = time.perf_counter()
  smz_main = smz_against_plain(device, 2, SMZ_ENVS)
  smz_cases = {
      f"B={SMZ_LARGE_ENVS}": smz_against_plain(device, 2, SMZ_LARGE_ENVS),
      f"deep-tree net, B={SMZ_DEEP_ENVS}": smz_against_plain(
          device, 2, SMZ_DEEP_ENVS, deep=True),
      f"deep-tree net, B={SMZ_DEEP_ENVS}, max_depth={SMZ_DEPTH_CAP}":
          smz_against_plain(device, 2, SMZ_DEEP_ENVS, deep=True,
                            max_depth=SMZ_DEPTH_CAP),
      f"edge B={SMZ_EDGE_ENVS} A=3 C=4 E=8 H=(16, 16) S=10 with one invalid "
      f"action, max_depth=2": smz_against_plain(
          device, 3, SMZ_EDGE_ENVS, SMZ_EDGE_NET, with_invalid=True,
          max_depth=2)}
  print(f"phase 16 Stochastic MuZero kernel vs plain, B={SMZ_ENVS} "
        f"sims={SMZ_SIMS} A=2 C=32 E=32 H=(64,) S=20: "
        f"{json.dumps(smz_main)}; {json.dumps(smz_cases)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  _, smz_roll, (args, kwargs) = drive_main_path(device, "stochastic", "smz")
  smz_roll["search_ms"] = time_ms(lambda: fused.fused_smz_search(
      *args, **kwargs), 10)
  smz_plan = fused.smz_launch_plan(args[0], args[3], **kwargs)
  smz_roll["plan"] = smz_plan._asdict()
  smz_roll["theoretical_warps_per_sm"] = min(
      fused.smz_blocks_per_sm(smz_plan, device),
      -(-smz_plan.grid // torch.cuda.get_device_properties(
          device).multi_processor_count)) * smz_plan.envs_per_block * (
              fused.SMZ_ENV_THREADS // 32)
  smz_roll["plain_search_ms"] = time_ms(
      lambda: fused.fused_smz_search_reference(*args, **kwargs), 1)
  smz_roll.update(smz_bound_ms(args, kwargs))
  print(f"phase 17 Stochastic MuZero rollout, {SMZ_ENVS} envs x {SMZ_SIMS} "
        f"sims x {MAIN_STEPS} steps: {json.dumps(smz_roll)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  ts = training_setup(device, family="smz")
  fill_ring(ts)
  W = SMZ_PRESAMPLE * SMZ_BATCH
  seg_idx = fused_sampler.draw_segments(ts.rs, ts.gen, W)
  gumbel = gumbel_noise(ts.gen, (MAIN_STEPS, W), device)
  sample_args = (ts.rs, seg_idx, gumbel, TRAIN_UNROLL)
  before = fused_sampler.launches
  raw, lay = fused_sampler.fused_sample_group(*sample_args, per_step_obs=True)
  torch.cuda.synchronize()
  check(fused_sampler.launches == before + 1, "the sampler launched")
  check(lay.obs_rows == 4 * TRAIN_UNROLL, "observation rows of every step")
  smz_sampler = compare_raw(raw, fused_sampler.fused_sample_group_reference(
      *sample_args, per_step_obs=True)[0], lay)
  smz_sampler["kernel_ms"] = time_ms(lambda: fused_sampler.fused_sample_group(
      *sample_args, per_step_obs=True), 20)
  smz_sampler["plain_ms"] = time_ms(
      lambda: fused_sampler.fused_sample_group_reference(
          *sample_args, per_step_obs=True), 3)
  smz_sampler["bound_ms"], smz_sampler["bound_by"] = sampler_bound_ms(
      lay, W, MAIN_STEPS)
  print(f"phase 18 sampler per_step_obs vs plain, C={TRAIN_CAPACITY} "
        f"L={MAIN_STEPS} K={TRAIN_UNROLL} W={W} on a ring of Stochastic "
        f"MuZero rollouts: {json.dumps(smz_sampler)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  smz_train_launches, smz_train = drive_training(
      device, ts, warmup=0, timed=1, window_updates=SMZ_PROFILE_UPDATES)
  print(f"phase 19 Stochastic MuZero training iteration, {SMZ_ENVS} envs x "
        f"{SMZ_SIMS} sims x {MAIN_STEPS} steps, {SMZ_UPDATES} updates of "
        f"{SMZ_BATCH} in groups of {ts.group} (hybrid feed): "
        f"{json.dumps(smz_train)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  smz_fit = drive_fit(device, os.path.dirname(os.path.abspath(__file__)),
                      "smz")
  print(f"phase 20 fit with Stochastic MuZero, 3 iterations, eval_every=2, "
        f"checkpoint_every=2, and a resume: {json.dumps(smz_fit)} "
        f"({time.perf_counter() - t0:.1f} s)")

  # ---- reanalyze, legal-action masks, AlphaZero, the env models ---------
  t0 = time.perf_counter()
  reanalyze = reanalyze_phase(device, t)
  reanalyze["fit"] = drive_reanalyze_fit(
      device, os.path.dirname(os.path.abspath(__file__)))
  reanalyze_fit = reanalyze["fit"]["launches"]
  print(f"phase 21 reanalyze on phase 6's ring, {REANALYZE_SEGMENTS} "
        f"segments x {MAIN_STEPS} steps a call, {MAIN_SIMS} and "
        f"{REANALYZE_SIMS} simulations, then fit with reanalyze_every=1: "
        f"{json.dumps(reanalyze)} ({time.perf_counter() - t0:.1f} s)")

  from muax_tpu_torch.envs import ConnectFour, TicTacToe
  t0 = time.perf_counter()
  masked = {}
  for policy in ("muzero", "gumbel"):
    masked[policy], masked_in = masked_rollout(
        device, ConnectFour(), policy, MAIN_ENVS, BOARD_STEPS)
    masked[policy]["search_ms"] = time_ms(lambda: fused_cuda(*masked_in),
                                          10)
    masked[policy]["plain_search_ms"] = time_ms(
        lambda: fused_reference(*masked_in), 1)
    masked[policy]["bound_ms"], masked[policy]["bound_by"] = (
        search_bound_ms(MAIN_ENVS, MAIN_SIMS, masked_in[0][3], True,
                        gumbel=policy == "gumbel"))
    masked[f"tictactoe_{policy}"], _ = masked_rollout(
        device, TicTacToe(), policy, EDGE_ENVS, BOARD_STEPS)
  print(f"phase 22 legal-action masks, Connect Four (A=7) at {MAIN_ENVS} "
        f"envs and TicTacToe (A=9) at {EDGE_ENVS}, x {MAIN_SIMS} sims x "
        f"{BOARD_STEPS} steps, each policy, the kernel timed on Connect "
        f"Four's last roots: {json.dumps(masked)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  alphazero = alphazero_phase(device)
  print(f"phase 23 AlphaZero on Connect Four (alphazero_connect4: resnet "
        f"4 x 32, {AZ_ENVS} games x {MAIN_SIMS} sims x {AZ_MOVES} moves, "
        f"batch 512, 8 updates), generic engine, then {AZ_EVAL_GAMES} games "
        f"against a random player: {json.dumps(alphazero)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  env_models = env_model_phase(device)
  print(f"phase 24 env models on Catch 10 x 5, {TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims, simulator and learned MLP model, 10 SGD steps: "
        f"{json.dumps(env_models)} ({time.perf_counter() - t0:.1f} s)")

  # ---- the conv and pixel path -------------------------------------------
  t0 = time.perf_counter()
  uint8_sampler = uint8_sampler_phase(device)
  print(f"phase 25 sampler kernel on a uint8 ring (PixelCatch 10 x 5 at "
        f"scale 1, 50 features), C={TRAIN_CAPACITY} L={MAIN_STEPS} "
        f"K={TRAIN_UNROLL} W={EZ_GROUP_WINDOWS}, both modes, against its "
        f"plain version and the ring cast to f32: "
        f"{json.dumps(uint8_sampler)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  conv_cpu = conv_against_cpu(device)
  print(f"phase 26 conv triplets on the card against the CPU (EZ 32 x 2 on "
        f"80 x 40 x 1 uint8, ResNet 64 x 4 on Connect Four planes), f32: "
        f"{json.dumps(conv_cpu)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  ez_rollout = ez_rollout_phase(device)
  print(f"phase 27 muzero_ez_conv_pixel rollout, {EZ_ROLLOUT_ENVS} envs x "
        f"{EZ_SIMS} sims x {MAIN_STEPS} steps, generic engine: "
        f"{json.dumps(ez_rollout)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  ez_training = ez_training_phase(device)
  print(f"phase 28 ez_conv_training and ez_conv_training_b1024, "
        f"{EZ_TRAIN_ENVS} envs x {EZ_SIMS} sims x {MAIN_STEPS} steps, "
        f"samples per insert 32, presample {EZ_PRESAMPLE}, one rollout and "
        f"one group of updates each: {json.dumps(ez_training)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  ez_fit = ez_fit_phase(device, os.path.dirname(os.path.abspath(__file__)))
  print(f"phase 29 fit on uint8 PixelCatch 10 x 5 at scale 1, EZ without "
        f"downsampling (32 x 2), {EZ_FIT_ENVS} envs x {EZ_FIT_SIMS} sims, "
        f"2 iterations, hybrid route: "
        f"{json.dumps(ez_fit)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  host = host_2048_phase(device, os.path.dirname(os.path.abspath(__file__)),
                         ptxas)
  print(f"phase 30 the 2048 host path at examples/run_2048.py's width "
        f"(E=64, S=300, towers (256, 256), weights in device memory): "
        f"search kernel vs plain at {HOST_ENVS} and {HOST_CHECK_ENVS} boards "
        f"x {HOST_SIMS} sims under legal masks, learner vs plain at "
        f"B={HOST_BATCH} K={HOST_UNROLL}, fit {HOST_ITERATIONS} iterations "
        f"on Native2048Pool: {json.dumps(host)} "
        f"({time.perf_counter() - t0:.1f} s)")
  t0 = time.perf_counter()
  surface = surface_phase(device)
  print(f"phase 31 the host-facing surface on {card} (no kernel): Sampled "
        f"MuZero at {SAMPLED_ROOTS} roots x {SAMPLED_SIMS} sims, the MuZero "
        f"agent at the CartPole notebook triplet ({AGENT_EPISODES} episodes "
        f"of at most {AGENT_EPISODE_CAP} steps at {AGENT_SIMS} sims, "
        f"{AGENT_UPDATES} updates of {AGENT_TRAJECTORIES * AGENT_WINDOWS} "
        f"windows, a batched act over {AGENT_BATCH_OBS}), Stochastic and "
        f"Diffusion MuZero agents over {SURFACE_OBS} observations: "
        f"{json.dumps(surface)} ({time.perf_counter() - t0:.1f} s)")
  t0 = time.perf_counter()
  par = parallel_phase(train["iteration_ms"])
  print(f"phase 32 the parallel layer on {card}: (a) the sharded program at "
        f"training_regime on a world of one through NCCL, (b) {PAR_RANKS} "
        f"ranks on the one card through gloo (each {TRAIN_ENVS // PAR_RANKS} "
        f"envs, batch {TRAIN_BATCH // PAR_RANKS}, ring "
        f"{TRAIN_CAPACITY // PAR_RANKS}), (c) the reduced gradient against "
        f"the ranks' own, (d) reanalyze of {PAR_REANALYZE_SEGMENTS} segments "
        f"over the ranks, (e) the Go tower channel-sharded at batch "
        f"{GO_BATCH}: {json.dumps(par)} ({time.perf_counter() - t0:.1f} s)")
  t0 = time.perf_counter()
  wide_smz, wide_smz_launches = wide_smz_phase(device)
  print(f"phase 33 Stochastic MuZero at examples/run_2048.py's width (A=4 "
        f"C=32 E=64 S=300, hidden (256, 256), tiles sharing every tower "
        f"read): "
        f"kernel vs plain at {' and '.join(map(str, SMZ_WIDE_ENVS))} boards "
        f"x {SMZ_SIMS} sims under legal masks, make_policy_fn(policy="
        f"'stochastic') {SMZ_WIDE_POLICY_CALLS} calls: "
        f"{json.dumps(wide_smz)} ({time.perf_counter() - t0:.1f} s)")
  t0 = time.perf_counter()
  examples = examples_phase(os.path.dirname(os.path.abspath(__file__)))
  # The fit-based scripts' launches (the others launch none).
  fits = [fig["launches"] for fig in examples.values()
          if isinstance(fig, dict) and isinstance(fig.get("launches"), dict)]
  example_search, example_gumbel = (sum(f["search_by_mode"][i] for f in fits)
                                    for i in (0, 1))
  example_sampler = sum(f["sampler"] for f in fits)
  example_learner = sum(f["learner"] for f in fits)
  print(f"phase 34 the example scripts on {card}, {EXAMPLE_ITERATIONS} "
        f"iterations each at their default widths (generic-engine scripts "
        f"at {EXAMPLE_GENERIC_SIMS} sims): {json.dumps(examples)} "
        f"({time.perf_counter() - t0:.1f} s)")
  if isinstance(examples["run_lunarlander"], str):
    print(f"phase 34 run_lunarlander: {examples['run_lunarlander']}")
  # The wide kernels' launches on the main paths that run them: phase 30's
  # fit and phase 34's run_2048 (MuZero; no path runs the wide Gumbel
  # mode, which phase 30 holds against its plain version).
  wide_search_launches = (host["fit"]["launches"]["search_wide"]
                          + examples["run_2048"]["launches"][
                              "search_by_mode"][0])
  wide_learner_launches = (host["fit"]["launches"]["learner_wide"]
                           + examples["run_2048"]["launches"]["learner"])
  check(wide_search_launches > 0 and wide_learner_launches > 0,
        "the main paths launched the wide kernels")
  uint8_line = {
      mode: {k: fig[k] for k in ("same_start", "max_abs_err",
                                 "bit_identical_to_f32_ring", "ms",
                                 "f32_ring_ms", "plain_ms", "bound_ms")}
      for mode, fig in uint8_sampler.items()}

  kernels = [{
      "name": "fused_muzero_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": "muax_tpu/search/fused.py:759",
      "launches": train_launches[0] + 2 + reanalyze_fit["search"]
                  + masked["muzero"]["launches"]
                  + masked["tictactoe_muzero"]["launches"]
                  + host["fit"]["launches"]["search"]
                  + par["launches"][0] + example_search,
      "max_abs_err": main_cmp["max_abs_err"],
      "ms": figures["search_ms"], "plain_ms": figures["plain_search_ms"],
      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
      **mlp_line(figures, main_groups, ptxas, "false"),
      "reanalyze_1280": {k: reanalyze[f"sims={MAIN_SIMS}"][k] for k in (
          "search_ms", "plain_search_ms", "bound_ms", "plan")},
      "masked_a7": {k: masked["muzero"][k] for k in (
          "search_ms", "plain_search_ms", "bound_ms", "plan")},
      "wide_towers_2048": {
          "launches": wide_search_launches,
          **{k: {f: v for f, v in host["search"][f"muzero_{B}"].items()
                 if f in WIDE_KEYS}
             for k, B in (("envs_64", HOST_ENVS),
                          ("envs_1024", HOST_CHECK_ENVS))}},
      "wide_instances": {k: v for k, v in host["instances"].items()
                         if k.startswith("fused_search_wide_kernel<false>")},
  }, {
      "name": "fused_sample_group", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_sampler.cu",
      "replaces": "muax_tpu/replay/fused_sampler.py:280",
      "launches": train_launches[1] + reanalyze_fit["sampler"]
                  + host["fit"]["launches"]["sampler"] + par["launches"][1]
                  + example_sampler,
      "max_abs_err": sampler_main["max_abs_err"],
      "ms": train["sampler_ms"], "plain_ms": train["plain_sampler_ms"],
      "bound_ms": sampler_bound, "bound_by": sampler_by, "library_ms": None,
      "uint8_ring": uint8_line["start_obs"],
  }, {
      "name": "fused_muzero_grad_raw", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_learner.cu",
      "replaces": "muax_tpu/models/fused_learner.py:665",
      "launches": train_launches[2] + reanalyze_fit["learner"]
                  + host["fit"]["launches"]["learner"] + par["launches"][2]
                  + example_learner,
      "max_abs_err": learner_main["max_abs_err"],
      "ms": train["learner_kernel_ms"], "plain_ms": train["plain_learner_ms"],
      "bound_ms": learner_bound, "bound_by": learner_by, "library_ms": None,
      "device_ms": (sum(train["learner_by_kernel_ms"].values())
                    if train["learner_by_kernel_ms"] else None),
      "wide_towers_2048": dict(
          {k: v for k, v in host["learner"].items()
           if k != "device_ms_by_kernel"}, launches=wide_learner_launches),
      "wide_instances": {k: v for k, v in host["instances"].items()
                         if "search" not in k},
  }, {
      "name": "fused_gumbel_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (policy="gumbel")',
      "launches": gumbel_train_launches[0] + masked["gumbel"]["launches"]
                  + masked["tictactoe_gumbel"]["launches"] + example_gumbel,
      "max_abs_err": gumbel_main["max_abs_err"],
      "ms": gumbel_figures["search_ms"],
      "plain_ms": gumbel_figures["plain_search_ms"],
      "bound_ms": gumbel_bound, "bound_by": gumbel_by, "library_ms": None,
      **mlp_line(gumbel_figures, gumbel_groups, ptxas, "true"),
      "masked_a7": {k: masked["gumbel"][k] for k in (
          "search_ms", "plain_search_ms", "bound_ms", "plan")},
      "wide_towers_2048": {
          "launches": 0,
          **{k: {f: v for f, v in host["search"][f"gumbel_{B}"].items()
                 if f in WIDE_KEYS}
             for k, B in (("envs_64", HOST_ENVS),
                          ("envs_1024", HOST_CHECK_ENVS))}},
      "wide_instances": {k: v for k, v in host["instances"].items()
                         if k.startswith("fused_search_wide_kernel<true>")},
  }, {
      "name": "fused_categorical_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (decode="linear", ln_tanh)',
      "launches": cat_train_launches[0],
      "max_abs_err": cat_cmp["muzero"]["main"]["max_abs_err"],
      "ms": cat_roll["muzero"]["search_ms"],
      "plain_ms": cat_roll["muzero"]["plain_search_ms"],
      "bound_ms": cat_roll["muzero"]["bound_ms"],
      "bound_by": cat_roll["muzero"]["bound_by"], "library_ms": None,
  }, {
      "name": "fused_categorical_gumbel_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (decode="linear", ln_tanh, '
                  'policy="gumbel")',
      "launches": cat_roll["gumbel"]["launches"],
      "max_abs_err": cat_cmp["gumbel"]["main"]["max_abs_err"],
      "ms": cat_roll["gumbel"]["search_ms"],
      "plain_ms": cat_roll["gumbel"]["plain_search_ms"],
      "bound_ms": cat_roll["gumbel"]["bound_ms"],
      "bound_by": cat_roll["gumbel"]["bound_by"], "library_ms": None,
  }, {
      "name": "fused_categorical_grad_raw", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_learner.cu",
      "replaces": "muax_tpu/models/fused_learner.py:665 (categorical "
                  "LearnerSpec)",
      "launches": cat_train_launches[2],
      "max_abs_err": cat_learner["main"]["max_abs_err"],
      "ms": cat_learner["kernel_ms"], "plain_ms": cat_learner["plain_ms"],
      "bound_ms": cat_learner["bound_ms"],
      "bound_by": cat_learner["bound_by"], "library_ms": None,
  }, {
      "name": "fused_smz_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_smz.cu",
      "replaces": "muax_tpu/search/fused.py:1369",
      "launches": smz_train_launches[0],
      "max_abs_err": smz_main["max_abs_err"],
      "ms": smz_roll["search_ms"], "plain_ms": smz_roll["plain_search_ms"],
      "bound_ms": smz_roll["bound_ms"], "bound_by": smz_roll["bound_by"],
      "library_ms": None, "plan": smz_roll["plan"],
      "theoretical_warps_per_sm": smz_roll["theoretical_warps_per_sm"],
      "instances": {k.split(":", 1)[1]: v for k, v in ptxas.items()
                    if k.startswith("fused_smz:fused_smz_kernel")},
  }, {
      "name": "fused_smz_wide_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_smz.cu",
      "replaces": "muax_tpu/search/fused.py:1369 (towers past a block's "
                  "shared memory)",
      "launches": wide_smz_launches,
      # The 3xTF32 bound (the rate its products run at), the f32 one beside.
      **{k: wide_smz[f"envs_{max(SMZ_WIDE_ENVS)}"][k] for k in (
          "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
          "bound_f32_fma_ms")},
      "library_ms": None,
      "wide_towers_2048": {k: {f: v for f, v in fig.items()
                               if f in WIDE_KEYS + ("bound_f32_fma_ms",)}
                           for k, fig in wide_smz.items()
                           if k.startswith("envs_")},
      "instances": {k.split(":", 1)[1]: v for k, v in ptxas.items()
                    if k.startswith("fused_smz:fused_smz_wide_kernel")},
  }, {
      "name": "fused_sample_group_per_step_obs", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_sampler.cu",
      "replaces": "muax_tpu/replay/fused_sampler.py:280 (per_step_obs=True)",
      "launches": smz_train_launches[1]
                  + ez_fit["launches"]["sampler_per_step_obs"],
      "max_abs_err": smz_sampler["max_abs_err"],
      "ms": smz_sampler["kernel_ms"], "plain_ms": smz_sampler["plain_ms"],
      "bound_ms": smz_sampler["bound_ms"],
      "bound_by": smz_sampler["bound_by"], "library_ms": None,
      "uint8_ring": uint8_line["per_step_obs"],
  }]
  print(f"total {time.perf_counter() - t_start:.1f} s")
  print(card)
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


def main():
  if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card; the port's kernels run only on one")
  root = os.path.dirname(os.path.abspath(__file__))
  if not os.path.isdir(os.path.join(root, "muax_tpu_torch")):
    sys.exit(f"chip_smoke: no muax_tpu_torch package beside {__file__}")
  sys.path.insert(0, root)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  run(torch.device("cuda", 0))


if __name__ == "__main__":
  main()
