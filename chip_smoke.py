#!/usr/bin/env python3
"""On-card smoke run of ccsd_tpu_torch, the PyTorch/CUDA port, on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # the phases below
    python3 chip_smoke.py --profile DIR   # also a torch.profiler breakdown
                                          # of 20 sampler steps of each path
                                          # and of training, community_small
                                          # and grid (phase_profile), traces
                                          # written to DIR
    python3 chip_smoke.py --profile DIR --profile-only   # build, profile

Phases, each printing one line of its own results:

1. device  -- require CUDA; print the card's name and power limit; switch
              TF32 off for matmuls and cuDNN so f32 means f32.
2. build   -- nvcc the seven kernel sources (ccsd_tpu_torch/csrc), in
              parallel (the f32 kernels and their bf16 variants).
3. kernels -- each forward kernel against its plain PyTorch version on the
              card, at every shape the community_small paths give it
              (``gmh_scores`` in f32 and in bf16, with a tolerance derived
              from one bf16 ulp of the head sums, printed;
              ``gmh_attention`` and ``channel_agg`` with a contiguous and a
              channels-last adjacency, ``channel_agg`` also folded and in
              bf16 with a tolerance of one bf16 ulp of each norm element);
              the two attention kernels also at the layer shapes of
              grid_small (B = 8, N = 49, head width 8) and
              grid_small_CC_two_stage (head width 6); ``gcn_aggregate``,
              ``channel_agg`` and their degree pass ``gcn_degrees`` also at
              grid's (B = 8, N = 361; ``channel_agg`` in every layout, f32
              and bf16, there and at N = 100); the two attention kernels
              (their tiled designs) and ``gmh_projection`` at grid's layer
              shapes (C = 2 on F_in 5, C = 8 on F_in 32, both adjacency
              layouts) and at N = 100 (a ragged last tile); above N = 64
              every kernel also called twice on the same inputs, bit for
              bit the same, and the attention maps exactly symmetric.  The
              bf16 variants of ``gcn_aggregate``, ``gmh_attention``,
              ``channel_agg`` (also with its bf16 norm) and ``gmh_scores``
              (bf16 and f32 products) at community_small_CC's layer shapes
              and grid_small's, each output bf16, within one bf16 ulp of
              the plain version's entry plus 1e-5 of its scale (see
              ``bf16_tol_of``).
4. models  -- ScoreNetworkX and ScoreNetworkA (unfused; fused f32; fused
              fast, the sampler's default) at B = 128 on the card (kernel
              path) against a float64 CPU copy of the same weights (plain
              path).
   grid    -- ScoreNetworkX of grid (B = 8, N = 361) the same way, with
              exact launch counts (``gcn_aggregate`` and ``gcn_degrees``
              once a layer), and grid's ScoreNetworkA (unfused, fused f32,
              fused fast; 7 AttentionLayers, each launching
              ``gcn_degrees`` and ``gmh_projection`` + ``gmh_attention``,
              or ``channel_agg`` + ``gmh_scores``).
5. sample  -- the full community_small graph sampler: B = 128, N = 20,
              SAMPLE_STEPS Euler + Langevin steps (the eval phase runs
              1000) through ``Sampler``, first with
              its defaults (``sample.fused`` and ``sample.fast`` on: the
              fused fast path), then with ``sample.fused: false`` (the
              unfused path); the launch counters of each run must equal the
              expected counts exactly, the graphs must be valid, and each
              run prints its steps/s.
   grid_sample -- after grid_small_eval: grid's sampler (B = 8, N = 361,
              GRID_SAMPLE_STEPS Reverse + Langevin steps) on both paths the
              same way, from
              the EMA weights of grid_small's run (the two configs' networks
              have the same widths; seeded weights overflow before step
              400 at every adjacency-head scale from 1 to 0.01, and a few
              epochs of grid's own training do not stop that).
6. train   -- community_small training at full width through ``Trainer``:
              each backward kernel (``gcn_aggregate_bwd``,
              ``gmh_attention_bwd``) against its plain backward at the
              train batch's shapes and layouts, at grid_small's and
              grid_small_CC_two_stage's, and (the tiled designs) at grid's
              layers (B = 8, N = 361; C = 2 on F_in 5, C = 8 on F_in 32)
              and at N = 100 (every gradient, within BWD_REL_TOL of its
              magnitude; ``gmh_attention_bwd`` with the adjacency in both
              layouts), each called twice on the same inputs with
              bit-identical results, and the tiled attention backward's
              own kernels alone (``gmh_bwd_layout`` exactly,
              ``gmh_score_grad``, whose cluster the card must grant, and
              ``gmh_attention_bwd_tiled``) against their plain versions at
              grid's layers and at N = 100; the gradients of the full loss
              on the card against a float64 CPU copy; 200 epochs from
              seeded weights on 100 graphs of community_small as the JAX
              package generates them (seed 0; one train batch of
              80 and one test batch of 20 an epoch) with finite, falling
              losses, exact launch counts per epoch and the train steps/s;
              the final checkpoint loaded by ``Sampler``, whose networks
              must give the trainer's EMA networks' outputs exactly; and a
              run resumed from the checkpoint the run wrote at epoch 100,
              which must end equal to it.
   grid_small_train -- grid_small (B = 8, N = 49; ScoreNetworkX depth 5,
              7 AttentionLayers) through ``Trainer`` on the dataset it
              generates from the seed, cut to GRID_SMALL_EPOCHS epochs (ten
              train and three test batches an epoch): finite, falling
              losses and exact launch counts an epoch.
   grid_train -- after grid_sample: grid (B = 8, N = 361) at its published
              widths: the gradients of the full loss on GRID_GRAD_GRAPHS
              training graphs against a float64 CPU copy (the train
              phase's bound), then ``Trainer`` for GRID_TRAIN_EPOCHS epochs
              (ten train and three test batches of 8 an epoch): finite
              losses, the last epoch's mean below the first's, exact
              launches an epoch (the tiled backwards: gcn_degrees for the
              attention's, none for gcn_aggregate_bwd's, which reads its
              forward's; gmh_projection, gmh_bwd_layout, gmh_score_grad and
              gmh_attention_bwd_tiled), train steps/s and peak memory.
   grid_small_eval -- its EMA checkpoint (``sample.use_ema: true``) through
              ``Sampler`` by the JAX protocol cut to its first round of 8
              graphs (GRID_SMALL_EVAL_GRAPHS),
              1000 Reverse + Langevin steps, scored against the 20 test
              graphs, on both paths: exact launch counts and the eight
              MMDs, finite.
   eval    -- the sampler's evaluation protocol on the 200-epoch checkpoint
              of the train phase, on the default path and with
              ``sample.fused: false``: 20 test graphs, one round of B = 128,
              1000 steps through ``Sampler``, scored by the four graph MMDs
              and the four lifted-CC MMDs (path_based lift) against the test
              split; the orbit counter built from the port's copy must equal
              the brute-force counter on every test and sampled graph, every
              MMD must be finite, every MMD of the test split against itself
              exactly 0, and each run's launch counts those phase 5 asserts;
              prints each path's eight MMDs and the host's eval seconds.
   cc_models -- community_small_CC's three networks at full width
              (ScoreNetworkX; ScoreNetworkA_CC unfused and fused, whose
              graph branch runs the attention kernels; ScoreNetworkF) at B =
              CC_NET_B on the card against a float64 CPU copy, within the
              larger of phase 4's tolerance and CC_F32_FACTOR times the CPU
              f32 copy's distance, with exact launch counts per call.
   cc_train -- community_small_CC (N = 20, E = 190, K = 1140) through
              ``Trainer`` on the lift of community_small's 100 graphs,
              CC_TRAIN_EPOCHS epochs in two calls (the checkpoint at the
              half kept aside): losses of the three networks finite and
              falling, exact launches an epoch, train steps/s, peak device
              memory; a run resumed at the half equals the uninterrupted one.
   bf16_models -- community_small_CC's networks as ``sample.score_dtype:
              bf16`` runs them (bf16 copies through the score functions;
              ScoreNetworkX, ScoreNetworkA unfused and fused fast,
              ScoreNetworkA_CC and ScoreNetworkA_Base_CC unfused and fused,
              ScoreNetworkF both forms) at B = CC_NET_B on the card against
              float64, within BF16_NET_FACTOR times the CPU bf16 copy's
              distance; exact launches of the bf16 kernels.
   cc_sample -- that checkpoint through ``Sampler`` by the JAX protocol (20
              test graphs, one round of 128, 1000 Euler + Langevin steps)
              on both paths at ``sample.score_dtype: f32`` and at the
              config's default (bf16, the bf16 kernels): exact launches,
              0/1 symmetric adjacency, rank-2 entries only on present edges
              and cells, finite graph and CC MMDs, cells per CC, steps/s
              and peak memory.
   carry_bf16 -- ``sample.dtype: bf16`` (the bf16 carry), default path,
              1000 steps: community_small on the train phase's checkpoint
              (128 graphs) and community_small_CC on cc_train's (the
              protocol): every network sees bf16 carries, valid finite
              outputs, exact launches, steps/s.
   ts_models -- the two-stage model's ScoreNetworkF (community_small_CC_
              two_stage) in its slab form over per-sample universes
              bridged from TS_NET_B community_small_CC graphs, on the card
              against a float64 CPU copy (the bound as cc_models'), with no
              hand kernel launched.
   ts_train -- ``TwoStageTrainer`` at full width (one full-batch step of
              the 80 training CCs an epoch) for TS_TRAIN_EPOCHS epochs:
              three finite, falling losses, exact launches an epoch, train
              steps/s, K_max and peak memory.
   ts_sample -- that checkpoint through ``TwoStageSampler`` by the JAX
              protocol (one round of 128, all kept; 1000 Euler + Langevin
              steps in each stage) on both graph paths: exact launches
              (stage 2 launches none), rank-2 entries only in valid slots
              and on rows of present nodes (with the count of those on
              edges absent from the generated adjacency), decoded cells on
              present nodes, finite graph and CC MMDs; prints each stage's
              steps/s, K_max, cells per CC, peak memory and stage 2's
              margin to overflow (its steps while finite, its largest |F|).
   base_cc_models -- the ablation network's configs: community_small_Base_CC's
              three networks at CC_NET_B and grid_small_Base_CC's at
              GRID_CC_NET_B (N = 49, E = 1176, K = 18,424), each adjacency
              network (ScoreNetworkA_Base_CC, whose graph branch runs the
              attention kernels) and F unfused and fused, on the card
              against a float64 CPU copy (cc_models' bound), with exact
              launches per call.
   base_cc_train -- community_small_Base_CC through ``Trainer`` as cc_train
              (BASE_CC_TRAIN_EPOCHS epochs, a resume at the half).
   base_cc_sample -- its checkpoint through ``Sampler`` by the JAX protocol
              (one round of 32: ``divide_batch`` 4) on both paths, f32 and
              bf16 scores, with cc_sample's gates.
   grid_cc -- dense grid_small_CC and grid_small_Base_CC at full width
              (B = 8; the lift of the 100 generated grids held on the card,
              its incidences in uint8): GRID_CC_EPOCHS epochs each through
              ``Trainer`` (exact launches an epoch, finite losses, train
              steps/s, peak memory), then the checkpoint through
              ``Sampler`` with its SDEs at GRID_CC_SAMPLE_STEPS steps, one
              round at the protocol's batch (8 and 1) on each path: exact
              launches, valid finite outputs, steps/s (the 1000-step
              sample is the quality run's).
   s4_sample -- the train phase's checkpoint through ``Sampler`` with
              ``sampler.predictor: S4`` (B = 128, 1000 steps, one
              evaluation of each network a step) on both paths: exact
              launches, valid graphs, steps/s.
   gmh_x   -- ScoreNetworkX_GMH (community_small with ``model.x``
              set): the network unfused, fused and fused fast at B = 128
              against float64; GMH_X_EPOCHS epochs through ``Trainer``
              (finite losses, exact launches an epoch); ``Sampler``, 128
              graphs, 1000 steps, on both paths (seeded weights, the
              adjacency head scaled as phase 5's): exact launches, valid
              graphs, steps/s.
7. timing  -- CUDA-event times of each kernel and its plain version at the
              path's shapes and layouts (device time from a CUDA-graph
              replay, and the time of an eager host loop), beside the
              card's bound for the same work and, where one PyTorch call
              computes the same function, that call's time;
              ``gmh_attention`` and ``channel_agg`` also with every
              adjacency contiguous, ``channel_agg`` also beside the
              ``gcn_norm`` + ``torch.matmul`` pair; grid's shapes of
              ``gcn_aggregate`` and ``channel_agg`` timed and kept out of
              the means; the backward kernels at the train batch's shapes,
              and at grid_small's, grid_small_CC_two_stage's and (tiled)
              grid's and N = 100's, out of the means, with the tiled
              backward's own kernels (``gmh_bwd_layout``,
              ``gmh_score_grad``, ``gmh_attention_bwd_tiled``) at grid's
              attention layers; the attention kernels' tiled designs at grid's shapes,
              out of the means, beside the floor the tanh sets (the tanhf
              rate measured on the card by a probe kernel), and
              ``gmh_projection`` at grid's shapes (its path); the PyTorch
              yardsticks: ``torch.matmul(norm, x)`` for ``channel_agg``,
              ``torch.baddbmm(b, norm, x W)`` for ``gcn_aggregate``, and
              ``torch.matmul(norm, x)`` then one ``torch.baddbmm`` over the
              stacked weights for ``gmh_projection`` (norm, x W and the
              weights formed before), ``torch.bmm(norm^T, dL/dout)`` (the
              dY product, norm formed before) for ``gcn_aggregate_bwd``,
              with the library's whole route beside it (that bmm, the dX
              matmul where dx is asked for, the dW einsum, dbias's sum);
              the bf16 variants at community_small_CC's shapes (the means)
              and grid_small's, their bounds at 2 bytes an element, beside
              the same PyTorch calls in bf16.

Each phase prints its seconds.

Then one JSON line of per-kernel results (``ms``, ``plain_ms`` and
``bound_ms`` per launch, averaged over the path's layer shapes; each shape
under ``shapes``; ``launches`` from the run of the path the kernel is on,
the most of any path's run, each path's under ``launches_by_path``),
the ``nvidia-smi`` name and power limit, and the result line.  Any failed
phase exits non-zero without the result line.  Imports only torch, numpy
and ccsd_tpu_torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain on the card: f32 on both sides, only the summation order
# differs (the kernel's FMA loops against cuBLAS), as in the CPU tests
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# whole networks, card (f32) vs a CPU copy in float64: those per-layer
# differences pass through three GCN layers or five AttentionLayers and the
# MLP heads.  The reference is float64 because the CPU's own f32 results
# were not stable on the card's machine: in 2 of about 12 runs its f32 CPU
# copy of ScoreNetworkX moved by up to 2e-4 from one process to the next,
# while the card's result equalled this repo's f32 CPU result elsewhere.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the fast network (bf16 head scores), card vs CPU: the two sides' f32 Q, K
# and head sums differ by rounding (the f32 networks agree to ~2e-5), and
# where such a value sits near a bf16 rounding boundary the two round it to
# neighbours one bf16 ulp apart (2^-8 relative): a head sum moves a map
# entry by up to ulp(|s|) / sqrt(O), a Q or K element a whole row of
# them, and the later layers carry that on.  No bound through five layers
# is tight, so the tolerance sits between that noise and what a wrong
# rounding point gives: phase 4 prints the distance from the fast to the f32
# fused network on the CPU and fails unless it exceeds the tolerance
# (first card run: card vs CPU 8.2e-3; fast vs f32 on the CPU 4.1e-2)
BF16_MODEL_TOL = dict(rtol=1e-4, atol=2e-2)
# H100 SXM data-sheet peaks (at the 700 W limit): HBM3, non-tensor f32, and
# the dense bf16 tensor cores (bf16 products with f32 accumulation)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TIMING_ITERS = 100  # CUDA-graph replays of a timed call (few, for the smoke's time limit)
SEEDED_ADJ_HEAD_SCALE = 0.01  # see smoke_sampler
# backward kernels against their plain backwards on the card: f32 on both
# sides, only the summation order differs; a gradient's entries cancel in
# its sums, so the bound scales with its largest entry (grad_compare)
BWD_REL_TOL = 1e-5
# the full loss's gradients, card (f32, the kernels forward and backward)
# against a float64 CPU copy.  Seeded full-width networks amplify f32
# rounding through five AttentionLayers and back (on the CPU an f32 copy
# lies up to ~1e-3 of a gradient's largest entry from float64), so the
# bound is set in each run by the CPU's own f32 copy of the same step: the
# card may lie GRAD_F32_FACTOR times as far from float64 as it, and never
# need be closer than GRAD_REL_TOL
GRAD_REL_TOL = 1e-4
GRAD_F32_FACTOR = 4.0
TRAIN_EPOCHS = 200  # full-width training run of the train phase
# grid's ScoreNetworkA (N = 361, seeded weights) is ill-conditioned in f32:
# its later layers normalise adjacencies of |entries| ~20 whose rows cancel,
# and a float32 copy on the CPU lies ~1e-2 from float64 (measured on the
# CPU: layer 6 alone, fed float64 inputs, 3e-3; the fast network, whose
# bf16 roundings flip, 0.2), so no f32 implementation meets MODEL_TOL
# there.  The card may lie GRID_F32_FACTOR times as far from float64 as the
# CPU's own f32 copy of the same network (as the train-grads gate), and
# never need be closer than phase 4's tolerance; B = GRID_NET_B keeps the
# CPU's float64 forward short
GRID_F32_FACTOR = 4.0
GRID_NET_B = 2
# grid_small's training run, cut from the config's 5000 epochs to fit the
# smoke's time limit (ten train and three test batches an epoch)
GRID_SMALL_EPOCHS = 100
# grid_small's evaluation: the protocol's first round of 8 graphs (its three
# rounds took ~165 s, which the smoke's time limit no longer holds)
GRID_SMALL_EVAL_GRAPHS = 8
# phase 5's seeded community_small sampler and grid's sampler run this many
# steps (not 1000) in the smoke: the launch counts and the graphs' checks
# hold at any count (the eval phase runs community_small's 1000 by the
# protocol), and the time limit does not hold their 1000-step runs beside
# the bf16 and GMH phases (a sampler that loads a checkpoint takes the
# checkpoint's steps, so the S4 phase stays at 1000)
SAMPLE_STEPS = GRID_SAMPLE_STEPS = 250
# community_small_CC: its networks on the card against float64 at this
# batch (the CPU's float64 forward of the K = 1140 Hodge ops stays short);
# the bound scales with the CPU f32 copy's own distance, as grid's does
CC_CONFIG = "community_small_CC"
CC_NET_B = 16
CC_F32_FACTOR = 4.0
# its training run, cut from the config's 5000 epochs (one train batch of
# 80 and one test batch of 20 an epoch)
CC_TRAIN_EPOCHS = 200
# grid (N = 361) through Trainer at its published widths, cut from the
# config's 5000 epochs (ten train and three test batches of 8 an epoch);
# the gradients of its full loss checked on GRID_GRAD_GRAPHS training
# graphs, which keeps the CPU's float64 copy of the step short
GRID_TRAIN_EPOCHS = 10
GRID_GRAD_GRAPHS = 2
GRID_PROFILE_STEPS = 10  # grid's train steps under --profile
# the two-stage model (community_small_CC_two_stage): its F network over
# universes bridged from TS_NET_B graphs against float64 (bound as
# cc_models'), and its training run, cut from the config's 3000 epochs (one
# full-batch step of the 80 training CCs an epoch, no test loss)
TS_CONFIG = "community_small_CC_two_stage"
TS_NET_B = 16
TS_TRAIN_EPOCHS = 100
# the ablation network ScoreNetworkA_Base_CC: community_small_Base_CC's
# networks against float64 at CC_NET_B, and its training run, cut from the
# config's 5000 epochs (one train and one test batch an epoch)
BASE_CC_CONFIG = "community_small_Base_CC"
# (at the smoke's seed 0 its 200-epoch checkpoint samples finite graphs;
# trained from seed 42 it does not: scripts/port_quality_run.py, PERF.md)
BASE_CC_TRAIN_EPOCHS = 200
# dense CC at grid_small's full size (N = 49, E = 1176, K = 18,424):
# grid_small_Base_CC's networks against float64 at GRID_CC_NET_B (the CPU's
# float64 copy of its four 1176 x 1176 x 18,424 products a graph stays
# short); grid_small_CC and grid_small_Base_CC through Trainer on the
# dataset held on the card (ten train and three test batches of 8 an
# epoch), GRID_CC_EPOCHS of 5000 epochs; then Sampler with the SDEs at
# GRID_CC_SAMPLE_STEPS steps on each path (the 1000-step sample is the
# quality run's: scripts/port_quality_run.py).  A barely trained F can take
# the reverse diffusion out of f32 (grid_small_CC's HF channel is cubic in
# F): scripts/cc_finite_sweep.py on the H100 found grid_small_CC's
# checkpoints finite on both paths at 5 and 10 epochs and not at 20, 30 or
# 50, grid_small_Base_CC's finite at all five, so both train 5 (10 until the
# smoke's time limit needed the seconds)
GRID_CC_CONFIG = "grid_small_CC"
GRID_BASE_CC_CONFIG = "grid_small_Base_CC"
GRID_CC_NET_B = 2
GRID_CC_EPOCHS = {GRID_CC_CONFIG: 5, GRID_BASE_CC_CONFIG: 5}
GRID_CC_SAMPLE_STEPS = 50
# the bf16 runs of the CC sample phases whose validity is not gated: (config,
# fused).  On the smoke's 200-epoch weights community_small_Base_CC's unfused
# bf16 run leaves f32 (scripts/cc_finite_sweep.py on the H100; its fused run
# and community_small_CC's stay finite).  It does on the CPU too, and there
# the JAX package's bf16 ScoreNetworkF gives the port's bf16 score at every
# state of the run's last 30 steps (scripts/bf16_score_check.py --unfused
# --last 60), so the JAX semantics take it out of f32.  Its launches and
# resolved dtypes are checked and its finiteness printed, its CCs and MMDs
# gated only where it stays finite (PERF.md §6, ROADMAP Queue C)
BF16_NOT_GATED = {(BASE_CC_CONFIG, False)}
# bf16_models: the bf16 score networks on the card may lie this many times as
# far from float64 as the CPU's bf16 copy (the plain versions) of the same
# score function (the CC_F32_FACTOR pattern: each bf16 rounding that the two
# sides take from f32 values a rounding apart may land one bf16 ulp apart)
BF16_NET_FACTOR = 4.0
# ScoreNetworkX_GMH's training run (community_small with model.x set),
# cut from the config's 5000 epochs
GMH_X_EPOCHS = 20
# config/grid_small_Base_CC.yaml sets model.num_layers_mlp: null, with which
# neither package builds ScoreNetworkF (an MLP of None layers raises); the
# smoke runs it with grid_small_CC's value
GRID_BASE_CC_NUM_LAYERS_MLP = 1


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def import_port():
    """Import the port from this checkout, and only from here."""
    sys.path.insert(0, HERE)
    import ccsd_tpu_torch

    where = os.path.dirname(os.path.abspath(ccsd_tpu_torch.__file__))
    check(where == os.path.join(HERE, "ccsd_tpu_torch"),
          f"ccsd_tpu_torch imported from {where}, not from this checkout")
    return ccsd_tpu_torch


# ----------------------------------------------------------------- costs --

def products(esize, flops):
    """The flops of a cost that products of its inputs do, where they may
    run on the bf16 tensor cores: all of ``flops`` for bf16 inputs
    (``esize`` 2), none for f32 ones (bound_ms)."""
    return flops if esize == 2 else 0


def gcn_cost(B, N, Fi, Fo, esize=4):
    """(bytes, flops, product flops) of one gcn_aggregate: inputs read
    once, output written once (``esize`` bytes an element: 2 for the bf16
    variant, whose products bound_ms times at the bf16 tensor cores' peak);
    FMA = 2 operations; norm (X W) in the cheaper of its two orders, d
    applied to the narrower side (the kernel takes (norm X) W)."""
    K = min(Fi, Fo)
    nbytes = esize * (B * N * Fi + B * N * N + Fi * Fo + Fo + B * N * Fo)
    mma = B * (2 * N * N * K              # aggregation
               + 2 * N * Fi * Fo)         # projection
    flops = mma + B * (N * N + 2 * N      # degree sums, clamp, rsqrt
                       + 2 * N * K        # d_m and d_n applied
                       + N * Fo)          # bias
    return nbytes, flops, products(esize, mma)


def gmh_cost(B, C, N, Fi, A, O, H, esize=4):
    """(bytes, flops, product flops) of one gmh_attention launch over C
    channels, taking norm (X W) in the cheaper of its two orders, as the
    kernel does; ``esize`` as gcn_cost's."""
    P = 2 * A + O
    nbytes = esize * (B * N * Fi + B * C * N * N + C * Fi * P + C * P
                  + B * N * C * O + B * N * N * C)
    mma = B * C * (2 * N * Fi * P        # (norm X) [Wq | Wk | Wv] or X [Wq | Wk | Wv]
                   + 2 * N * N * min(Fi, P)  # norm X or norm (X W)
                   + 2 * N * N * A)      # Q_h K_h^T over all heads
    flops = mma + B * C * (3 * N * N + N   # degree, rsqrt, d A' d^T
                           + N * P         # bias
                           + 3 * H * N * N  # scale, tanh, head sum
                           + 3 * N * N)    # mean, symmetrise
    return nbytes, flops, products(esize, mma)


def agg_cost(B, C, N, F, esize=4):
    """(bytes, flops, product flops) of one channel_agg call: the
    adjacency and x read once, the output written once; the
    normalisation's operations (degree sums, clamp and rsqrt, d_m on x and
    d_n on the sums) beside the product's FMAs; ``esize`` as gcn_cost's."""
    nbytes = esize * (B * C * N * N + B * N * F + B * C * N * F)
    mma = B * C * 2 * N * N * F
    flops = mma + B * C * (N * N + 2 * N + 2 * N * F)
    return nbytes, flops, products(esize, mma)


def degrees_cost(B, C, N):
    """(bytes, flops) of one gcn_degrees launch: one read of the
    adjacency, one write of the degrees; a sum, clamp and rsqrt a row."""
    return 4 * (B * C * N * N + B * C * N), B * C * (N * N + 2 * N)


def scores_cost(B, C, N, A, H, O, esize=4):
    """(bytes, flops, product flops) of one gmh_scores launch: Q and K
    read once, the channels-last map written once; ``esize`` as
    gcn_cost's."""
    nbytes = esize * (2 * B * C * N * A + B * N * N * C)
    mma = B * C * 2 * N * N * A            # Q_h K_h^T over all heads
    flops = mma + B * C * (3 * H * N * N   # scale, tanh, head sum
                           + 3 * N * N)    # mean, symmetrise
    return nbytes, flops, products(esize, mma)


def gcn_bwd_cost(B, N, Fi, Fo, need_x, need_adj):
    """(bytes, flops) of one gcn_aggregate_bwd launch: x, adj, the weight
    and dL/dout read once; dx and dadj (where the call asks for them), dW
    and dbias written once; the weights' batch sum counted as the
    product's own adds.  Operations as gcn_cost counts the forward: the
    degrees and their slopes, d applied, the recomputed Y = X W, dY =
    norm^T G, dW = X^T dY, dbias; then dX = dY W^T, and for dA the product
    G Y^T with each row's degree term (two products and two adds an entry)
    and the direct term (two products and an add)."""
    nbytes = 4 * (B * N * Fi * (1 + need_x) + B * N * N * (1 + need_adj) + 2 * Fi * Fo
                  + B * N * Fo + Fo)
    flops = B * (N * N + 3 * N              # degree sums, clamp and rsqrt, slope
                 + 2 * N * Fo               # d_m and d_n applied
                 + 2 * N * Fi * Fo          # Y = X W
                 + 2 * N * N * Fo           # dY = norm^T G
                 + 2 * N * Fi * Fo          # dW
                 + N * Fo                   # dbias
                 + need_x * 2 * N * Fi * Fo                    # dX
                 + need_adj * (2 * N * N * Fo + 8 * N * N))    # gN = G Y^T, dA
    return nbytes, flops


def gmh_bwd_cost(B, C, N, Fi, A, O, H, need_x, need_adj):
    """(bytes, flops) of one gmh_attention_bwd launch over C channels: x,
    the adjacency, the six weights, dL/dV and dL/dA read once; dx and dadj
    (where asked for) and the weights' gradients written once.  Operations:
    the forward's degrees, norm X, Q and K and head scores recomputed (as
    gmh_cost counts them, V not); gM and gS; gQ = gS K and gK = gS^T Q;
    dW = NX^T gP with the biases; gNX = gP W^T; then dX = norm^T gNX, and
    for dA gN = gNX X^T with the degree and direct terms."""
    P = 2 * A + O
    nbytes = 4 * (B * N * Fi * (1 + need_x) + B * C * N * N * (1 + need_adj)
                  + 2 * C * (Fi * P + P) + B * N * C * O + B * N * N * C)
    flops = B * C * (3 * N * N + N             # degree, rsqrt, d A' d^T
                     + 2 * N * N * Fi           # NX = norm X
                     + 2 * N * Fi * 2 * A + 2 * N * A  # Q, K and their biases
                     + 2 * N * N * A + 2 * H * N * N   # head sums, scale and tanh
                     + 2 * N * N + 4 * H * N * N       # gM; gS
                     + 4 * N * N * A            # gQ, gK
                     + 2 * N * Fi * P + N * P   # dW, db
                     + 2 * N * P * Fi           # gNX
                     + need_x * 2 * N * N * Fi  # dX
                     + need_adj * (2 * N * N * Fi + 8 * N * N))  # gN, dA
    return nbytes, flops


def score_grad_cost(B, C, N, A, H):
    """(bytes, flops) of one gmh_score_grad launch: Q | K and the
    symmetrised dL/dA (the layout pass's gm) read once, gQ | gK written
    once; the head sums, scale and tanh and gS once a head and entry (as
    gmh_bwd_cost counts them), and the products gS K and gS^T Q."""
    nbytes = 4 * (2 * B * C * N * 2 * A + B * C * N * N)
    flops = B * C * (2 * N * N * A + 2 * H * N * N + 4 * H * N * N + 4 * N * N * A)
    return nbytes, flops


def layout_cost(B, C, N, copy_adj):
    """(bytes, flops) of one gmh_bwd_layout launch: dL/dA read once and gm
    written once (its N x N entries; the rows' padding not counted), with
    copy_adj the adjacency read and its copy written too; an add and a
    multiply an entry of gm."""
    return 4 * 2 * B * C * N * N * (1 + copy_adj), 2 * B * C * N * N


def row_tile_cost(B, C, N, Fi, A, O, need_x, need_adj):
    """(bytes, flops) of one gmh_attention_bwd_tiled launch: x, the
    adjacency, the degrees, the three weights, gQ | gK and dL/dV read once;
    dx and dadj (where asked for) and the weights' gradients written once.
    Operations: V = A'^T (d o gP) with d applied, Z, dW and db; U = V W^T
    (for dX or dA) and dX's rows with their sum over channels; for dA gNX,
    P1 = A' (d o X) with d applied, the rows' sums, dr and dA (its product,
    d applied twice and dr added)."""
    P = 2 * A + O
    nbytes = 4 * (B * N * Fi * (1 + need_x) + B * C * N * N * (1 + need_adj) + B * C * N
                  + 2 * C * (Fi * P + P) + B * C * N * 2 * A + B * N * C * O)
    flops = B * C * (2 * N * N * P + N * N + N * P           # V, d applied; Z
                     + 2 * N * Fi * P + N * P                 # dW, db
                     + (need_x or need_adj) * 2 * N * P * Fi  # U
                     + need_x * 2 * N * Fi                    # dX rows, channel sum
                     + need_adj * (2 * N * P * Fi             # gNX
                                   + 2 * N * N * Fi + 2 * N * N  # P1, row sums
                                   + 4 * N * Fi               # dr
                                   + 2 * N * N * Fi + 3 * N * N))  # dA
    return nbytes, flops


def proj_cost(B, C, N, Fi, A, O):
    """(bytes, flops) of one gmh_projection launch: x, the adjacency, the
    degrees and the weights read once, Q | K and V written once; d A' d
    applied as the sums read it, norm X, the projection and the bias."""
    P = 2 * A + O
    nbytes = 4 * (B * N * Fi + B * C * N * N + B * C * N + C * (Fi * P + P)
                  + B * C * N * 2 * A + B * N * C * O)
    flops = B * C * (N * N + 2 * N * N * Fi + N * Fi   # d_m a, the sums, d_n
                     + 2 * N * Fi * P + N * P)          # projection, bias
    return nbytes, flops


def tanh_count(B, C, N, H):
    """tanhf calls of one attention map launch: one a head and entry."""
    return B * C * N * N * H


def bound_ms(nbytes, flops, mma=0):
    """The least time of a cost, in ms, and what bounds it: its bytes over
    HBM's rate or its operations, the ``mma`` flops of bf16 products at the
    bf16 tensor cores' peak and the rest at the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mma / BF16_FLOP_PER_S + (flops - mma) / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- helpers --

def _events_ms(run, iters):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters=TIMING_ITERS):
    """(device ms, host-loop ms) of one fn() call, by CUDA events.

    Device: ``iters`` calls captured in one CUDA graph and replayed, so the
    host's launch cost is out of the time.  Host loop: the same calls issued
    eagerly back to back, which is what the sampler's Python loop pays when
    the host, not the card, sets the pace.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, iters)
    del graph

    def loop():
        for _ in range(iters):
            fn()

    loop()
    return device, _events_ms(loop, iters)


def compare(got, ref, tol):
    """(max abs err, max rel err, within tolerance) of got against ref."""
    import torch

    diff = (got - ref).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    rel = (diff / ref.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok and bool(got.isfinite().all())


def path_shapes(models):
    """The kernel cases of the community_small paths, from the built models.

    gcn: (name, B, N, F_in, F_out, loop); gmh: (name, B, C, N, F_in, attn,
    F_out, H); agg: (name, B, C, N, F_in); scores: (name, B, C, N, attn, H,
    F_out).  The ``improved`` GCN case (loop = 2) is checked but is not on
    the path.
    """
    from ccsd_tpu_torch.kernels.gmh_attention import head_split

    B, N = 128, models["adj"].max_node_num
    gcn = [(f"x.layers.{k}", B, N, l.in_channels, l.out_channels, l.loop)
           for k, l in enumerate(models["x"].layers)]
    gcn.append(("improved", B, N, gcn[-1][3], gcn[-1][4], 2.0))
    gmh, agg, scores = [], [], []
    for k, layer in enumerate(models["adj"].layers):
        a, C, name = layer.attn[0], len(layer.attn), f"adj.layers.{k}"
        H = head_split(a.attn_dim, a.num_heads)[0]
        gmh.append((name, B, C, N, a.in_dim, a.attn_dim, a.out_dim, H))
        agg.append((name, B, C, N, a.in_dim))
        scores.append((name, B, C, N, a.attn_dim, H, a.out_dim))
    return {"gcn": gcn, "gmh": gmh, "agg": agg, "scores": scores, **more_shapes(),
            **grid_shapes(), **bf16_shapes()}


def attention_layer_cases(name, c):
    """(gmh cases, scores cases) of config c's first and later
    AttentionLayer, named ``<name>.layers.<k>``."""
    from ccsd_tpu_torch.kernels.gmh_attention import head_split

    m, B, N = c.model, int(c.data.batch_size), int(c.data.max_node_num)
    gmh, scores = [], []
    for k, (Fi, A, C) in enumerate(((c.data.max_feat_num, m.nhid, m.c_init),
                                    (m.nhid, m.adim, m.c_hid))):
        H = head_split(A, m.num_heads)[0]
        gmh.append((f"{name}.layers.{k}", B, C, N, Fi, A, m.nhid, H))
        scores.append((f"{name}.layers.{k}", B, C, N, A, H, m.nhid))
    return gmh, scores


# kernel-check cases off the community_small path (phase 3 only): grid_small
# (N = 49, head width 8) and the graph widths of grid_small_CC_two_stage
# (N = 49, adim 24: head width 6), each config's first and later layer
EXTRA_CONFIGS = ("grid_small", "grid_small_CC_two_stage")
# grid (N = 361): the two normalising kernels and their degree pass, the
# attention kernels' tiled designs and the projection they launch; checked
# in phase 3, timed in phase 7 beside the path's shapes and kept out of the
# community_small means (the projection runs on grid's path only)
GRID_CONFIG = "grid"
# an N that the tiles do not divide (three of 32 and one of 4; six of 16
# and one of 4), at grid's widths and batch, for the tiled kernels (phase 3)
RAGGED_N = 100


def grid_shapes():
    """``gcn_more`` and ``agg_more`` cases of GRID_CONFIG's first and later
    ScoreNetworkX / AttentionLayer (``agg_more`` also at N = RAGGED_N), and
    the ``degrees`` cases they launch (each adjacency in the layout its
    layer passes)."""
    from ccsd_tpu_torch.utils.config import get_config

    c = get_config(GRID_CONFIG, seed=0, folder=HERE)
    m, B, N, F = c.model, int(c.data.batch_size), int(c.data.max_node_num), int(c.data.max_feat_num)
    gcn = [(f"{GRID_CONFIG}.x.layers.{k}", B, N, Fi, m.nhid, 1.0)
           for k, Fi in enumerate((F, m.nhid))]
    agg = [(f"{GRID_CONFIG}.adj.layers.{k}", B, C, N, Fi)
           for k, (C, Fi) in enumerate(((m.c_init, F), (m.c_hid, m.nhid)))]
    degrees = [(f"{GRID_CONFIG}.x.layers", B, 1, N, "contiguous")]
    degrees += [(name, B, C, N, "contiguous" if name.endswith(".0") else "channels-last")
                for name, B, C, N, _ in agg]
    agg += [(f"{GRID_CONFIG}.n{RAGGED_N}.adj.layers.{k}", B, C, RAGGED_N, Fi)
            for k, (_, _, C, _, Fi) in enumerate(agg[:2])]
    gmh, _ = attention_layer_cases(GRID_CONFIG, c)
    ragged, _ = attention_layer_cases(f"{GRID_CONFIG}.n{RAGGED_N}", ragged_config())
    return {"gcn_more": gcn, "agg_more": agg, "degrees": degrees, "proj": gmh,
            "proj_more": ragged}


def ragged_config():
    """grid's config with max_node_num RAGGED_N."""
    from ccsd_tpu_torch.utils.config import AttrDict, get_config

    c = AttrDict(get_config(GRID_CONFIG, seed=0, folder=HERE).to_dict())
    c.data.max_node_num = RAGGED_N
    return c


def more_shapes():
    """``gmh_more`` and ``scores_more`` cases from EXTRA_CONFIGS, grid and
    grid at N = RAGGED_N, as the ScoreNetworkA layers of each config give
    them (models/score_a.py)."""
    from ccsd_tpu_torch.utils.config import get_config

    gmh, scores = [], []
    configs = [(name, get_config(name, seed=0, folder=HERE)) for name in EXTRA_CONFIGS]
    configs += [(GRID_CONFIG, get_config(GRID_CONFIG, seed=0, folder=HERE)),
                (f"{GRID_CONFIG}.n{RAGGED_N}", ragged_config())]
    for name, c in configs:
        g, sc = attention_layer_cases(name, c)
        gmh += g
        scores += sc
    return {"gmh_more": gmh, "scores_more": scores}


def sym(t):
    import torch

    t = torch.triu(t, 1)
    return t + t.transpose(-1, -2)


def glorot(shape, gen, dev):
    import torch

    bound = (6.0 / (shape[-2] + shape[-1])) ** 0.5
    return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound


def gcn_inputs(case, gen, dev):
    """A standard-normal adjacency (a noisy one, as the sampler passes) at
    the path's N; at grid's N = 361 a 0/1 adjacency of mean degree 4, as
    grid's graphs have: a standard-normal row of 361 entries sums to near
    zero as often as not, and two f32 orders of the same sum then differ by
    up to 5e-5 (the kernel's (norm X) W against cuBLAS's norm (X W))."""
    import torch

    _, B, N, Fi, Fo, loop = case
    x = torch.randn(B, N, Fi, generator=gen, device=dev)
    if N > 64:
        adj = sym((torch.rand(B, N, N, generator=gen, device=dev) < 4 / N).float())
    else:
        adj = sym(torch.randn(B, N, N, generator=gen, device=dev))
    w = glorot((Fi, Fo), gen, dev)
    b = 0.1 * torch.randn(Fo, generator=gen, device=dev)
    return (x, adj, w, b, loop)


def gmh_inputs(case, gen, dev):
    """A standard-normal adjacency where one block holds the graph; above
    N = 64 a 0/1 one of mean degree 4, as grid's graphs have (gcn_inputs
    says why)."""
    import torch

    _, B, C, N, Fi, A, O, H = case
    x = torch.randn(B, N, Fi, generator=gen, device=dev)
    if N > 64:
        adj = sym((torch.rand(B, C, N, N, generator=gen, device=dev) < 4 / N).float())
    else:
        adj = sym(torch.randn(B, C, N, N, generator=gen, device=dev))
    r = lambda *s: 0.1 * torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    w = [glorot((C, Fi, A), gen, dev), r(C, A), glorot((C, Fi, A), gen, dev),
         r(C, A), glorot((C, Fi, O), gen, dev), r(C, O)]
    return (x, adj, *w, H, O)


def gmh_inputs_channels_last(case, gen, dev):
    """As gmh_inputs, the adjacency a channels-last view, as the previous
    layer's MLP leaves it for the next AttentionLayer."""
    x, adj, *rest = gmh_inputs(case, gen, dev)
    return (x, channels_last(adj), *rest)


def first_layer(case):
    return case[0].rsplit(".", 1)[-1] == "0"


def gmh_path_inputs(case, gen, dev):
    """As gmh_inputs, the adjacency in the layout the unfused path gives the
    layer: the first layer's (B, C, N, N)-contiguous (``pow_tensor``'s), a
    later layer's the channels-last view the previous layer's MLP leaves."""
    return (gmh_inputs if first_layer(case) else gmh_inputs_channels_last)(case, gen, dev)


def contiguous_adj(x, adj, *rest):
    return (x, adj.contiguous(), *rest)


def proj_inputs(case, gen, dev):
    """gmh_projection's inputs in the layout the unfused path gives the
    layer, with the degrees gcn_degrees would give."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain

    x, adj, *w, _, _ = gmh_path_inputs(case, gen, dev)
    return (x, adj, gcn_degrees_plain(adj), *w)


def proj_inputs_other_layout(case, gen, dev):
    x, adj, deg, *w = proj_inputs(case, gen, dev)
    return (x, channels_last(adj) if first_layer(case) else adj.contiguous(), deg, *w)


def channels_last(adj):
    """The (B, C, N, N) view of channels-last storage that a previous
    layer's MLP leaves."""
    return adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def agg_inputs(case, gen, dev):
    """The fused layer's adjacency (contiguous) and x."""
    import torch

    _, B, C, N, F = case
    adj = sym(torch.rand(B, C, N, N, generator=gen, device=dev))
    return (adj, torch.randn(B, N, F, generator=gen, device=dev))


def agg_inputs_channels_last(case, gen, dev):
    adj, x = agg_inputs(case, gen, dev)
    return (channels_last(adj), x)


def agg_path_inputs(case, gen, dev):
    """The adjacency in the layout the fused path gives the layer, as
    gmh_path_inputs."""
    return (agg_inputs if first_layer(case) else agg_inputs_channels_last)(case, gen, dev)


def degrees_inputs(case, gen, dev):
    import torch

    _, B, C, N, layout = case
    adj = sym(torch.rand(B, C, N, N, generator=gen, device=dev))
    return (adj if layout == "contiguous" else channels_last(adj),)


def bf16_agg_tol(adj, x):
    """channel_agg in bf16, kernel vs plain, element by element: both round
    x and each norm element to bf16 once, but their f32 norm elements
    (degrees summed in another order) may round to the two bf16 neighbours
    of a value, one bf16 ulp of |norm| apart; that summed against |x| over
    m, plus the f32 tolerance."""
    import torch
    from ccsd_tpu_torch.kernels.gcn import gcn_norm
    from ccsd_tpu_torch.kernels.gmh_scores import round_bf16

    a = adj if adj.dim() == 4 else adj.unflatten(1, (-1, x.shape[1]))
    norm = gcn_norm(a).abs()
    ulp = torch.exp2(torch.floor(torch.log2(norm.clamp_min(1e-30))) - 7)
    bound = (ulp @ round_bf16(x).abs()[:, None]).reshape(*adj.shape[:-1], x.shape[-1])
    return dict(rtol=0.0, atol=KERNEL_TOL["atol"] + bound)


def scores_inputs(case, gen, dev):
    """Q and K as the fused layer hands them over: strided column blocks of
    one (C, B, N, 2A + O) projection."""
    import torch

    _, B, C, N, A, H, O = case
    qkv = torch.randn(C, B, N, 2 * A + O, generator=gen, device=dev).transpose(0, 1)
    return (qkv[..., :A], qkv[..., A:2 * A], H, O)


def bf16_scores_tol(q, k, H, O):
    """Kernel vs plain in bf16, element by element: both round Q, K and each
    head's sum s_h to bf16 once, but their f32 sums may round to the two
    bf16 neighbours of the exact sum.  That moves tanh(s_h / sqrt(O)) by at
    most one bf16 ulp of |s_h| over sqrt(O) (tanh has slope <= 1); the head
    mean and the symmetrisation average those bounds."""
    import torch

    B, C, N, A = q.shape
    s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, -1),
                     k.reshape(B, C, N, H, -1))
    ulp = torch.exp2(torch.floor(torch.log2(s.abs().clamp_min(1e-30))) - 7)
    b = ulp.mean(dim=2) / math.sqrt(O)
    b = ((b + b.transpose(-1, -2)) / 2).permute(0, 2, 3, 1)
    return dict(rtol=0.0, atol=KERNEL_TOL["atol"] + b)


def tol_text(tol):
    return json.dumps({k: v if isinstance(v, float) else
                       f"elementwise, max {v.max().item():.3e}" for k, v in tol.items()})


# ------------------------------------------------------ the bf16 variants --
#
# The four forward kernels take bf16 tensors (a whole graph a block, N <=
# 64) for the bf16 score networks (``sample.score_dtype: bf16``, the
# default of community_small_CC).  Phase 3 holds each to its plain version
# (``plain_in_f32``: the f32 plain function of the same bf16 inputs upcast,
# rounded to bf16 once) within ``bf16_kernel_tol`` (one bf16 ulp of the
# plain entry plus 1e-5 of the output's scale: both round an f32 value
# once, from sums in another order), plus, for ``gmh_scores`` with bf16
# products, ``bf16_scores_tol`` (the head sums' own rounding), and for
# ``channel_agg`` with its bf16 norm, ``bf16_agg_tol``; at community_small_CC's
# layer shapes (its widths are community_small's; N = 20, B = 128) and
# grid_small's (N = 49, B = 8, kept out of the timing means: no config
# samples grid_small in bf16).  A bf16 call counts under the kernel's own
# name; the kernels line lists each variant as its own entry, its launches
# those of the runs marked BF16_RUN, whose networks run in bf16.
BF16_KERNELS = ("gcn_aggregate", "gmh_attention", "channel_agg", "gmh_scores")
BF16_RUN = " [bf16 kernels]"


def bf16_shapes():
    """``<key>_bf16`` cases (community_small_CC's first and later layers)
    and ``<key>_bf16_more`` cases (grid_small's) of the four kernels."""
    from ccsd_tpu_torch.utils.config import get_config

    out = {}
    for name, suffix in ((CC_CONFIG, "_bf16"), (GRID_SMALL, "_bf16_more")):
        c = get_config(name, seed=0, folder=HERE)
        m, B, N = c.model, int(c.data.batch_size), int(c.data.max_node_num)
        F = int(c.data.max_feat_num)
        gmh, scores = attention_layer_cases(name, c)
        out[f"gcn{suffix}"] = [(f"{name}.x.layers.{k}", B, N, Fi, m.nhid, 1.0)
                               for k, Fi in enumerate((F, m.nhid))]
        out[f"agg{suffix}"] = [(n, B, C, N_, Fi) for n, B, C, N_, Fi, *_ in gmh]
        out[f"gmh{suffix}"], out[f"scores{suffix}"] = gmh, scores
    return out


def as_bf16(mk):
    """The maker ``mk`` with its float tensors in bf16 (a channels-last
    adjacency keeps its strides)."""
    import torch

    def make(case, gen, dev):
        return tuple(a.to(torch.bfloat16) if isinstance(a, torch.Tensor) else a
                     for a in mk(case, gen, dev))
    return make


def scores_inputs_bf16(case, gen, dev):
    """scores_inputs in bf16: strided column blocks of one bf16 projection."""
    import torch

    _, B, C, N, A, H, O = case
    qkv = torch.randn(C, B, N, 2 * A + O, generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    return (qkv[..., :A], qkv[..., A:2 * A], H, O)


def widened(fn):
    """fn, its outputs checked to be bf16 and widened to f32."""
    import torch

    def run(*a):
        out = fn(*a)
        outs = out if isinstance(out, tuple) else (out,)
        check(all(o.dtype == torch.bfloat16 for o in outs),
              f"a bf16 call returned {[o.dtype for o in outs]}")
        outs = tuple(o.float() for o in outs)
        return outs if isinstance(out, tuple) else outs[0]
    return run


def bf16_plain(plain):
    """The plain version of a bf16 kernel (``plain_in_f32``)."""
    import torch
    from ccsd_tpu_torch.kernels.gcn import plain_in_f32

    return lambda *a: plain_in_f32(plain, torch.bfloat16, *a)


def bf16_tol_of(plain, extra=None):
    """A tolerance maker of phase 3 for a bf16 kernel: ``bf16_kernel_tol`` of
    each plain output, plus ``extra(*args)`` (an atol) on the first."""
    from ccsd_tpu_torch.kernels.gcn import bf16_kernel_tol

    def tol(*a):
        ref = widened(bf16_plain(plain))(*a)
        tols = [bf16_kernel_tol(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
        if extra is not None:
            tols[0]["atol"] = tols[0]["atol"] + extra(*a)
        return tols
    return tol


# ---------------------------------------------------------------- phases --

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", nvidia_smi=repr(smi_name_power()),
        torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)


def phase_build():
    from ccsd_tpu_torch.kernels import build

    seconds = build.build_all()
    regs = {name: " | ".join(ln.split("info    : ")[-1].strip()
                             for ln in log.splitlines() if "Used" in ln)
            for name, log in build.BUILD_LOG.items()}
    say("build", seconds=f"{seconds:.2f}", kernels=",".join(build.SIGNATURES),
        ptxas=json.dumps(regs))


def kernel_specs():
    """(kernel, variant, shape key, inputs, kernel fn, plain fn, tolerance
    of (args)) of every kernel check, for every kernel of the port."""
    import functools

    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain
    from ccsd_tpu_torch.kernels.gcn import (
        gcn_aggregate,
        gcn_aggregate_plain,
        gcn_degrees,
        gcn_degrees_plain,
    )
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention,
        gmh_attention_plain,
        gmh_projection,
        gmh_projection_plain,
    )
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    def folded(fn):  # the probes' (B, C*N, N) form of the same sum
        def run(adj, x):
            B, C, N, _ = adj.shape
            return fn(adj.view(B, C * N, N), x).view(B, C, N, -1)
        return run

    f32 = lambda *args: KERNEL_TOL  # noqa: E731
    agg_bf16 = functools.partial(channel_agg, bf16=True)
    agg_bf16_plain = functools.partial(channel_agg_plain, bf16=True)
    scores_bf16 = functools.partial(gmh_scores, bf16=True)
    scores_bf16_plain = functools.partial(gmh_scores_plain, bf16=True)

    def bf16(kname, variant, key, mk, kern, plain, extra=None):
        return (f"{kname} (bf16)", variant, f"{key}_bf16", mk, widened(kern),
                widened(bf16_plain(plain)), bf16_tol_of(plain, extra))

    def norm_ulps(adj, x, *_):
        return bf16_agg_tol(adj.float(), x.float())["atol"]

    def head_sum_ulps(q, k, H, O):
        return bf16_scores_tol(q.float(), k.float(), H, O)["atol"]

    return [
        bf16("gcn_aggregate", "bf16", "gcn", as_bf16(gcn_inputs), gcn_aggregate,
             gcn_aggregate_plain),
        bf16("gmh_attention", "bf16 path layout", "gmh", as_bf16(gmh_path_inputs),
             gmh_attention, gmh_attention_plain),
        bf16("channel_agg", "bf16 path layout", "agg", as_bf16(agg_path_inputs), channel_agg,
             channel_agg_plain),
        bf16("channel_agg", "bf16 path layout, bf16 norm", "agg", as_bf16(agg_path_inputs),
             agg_bf16, agg_bf16_plain, norm_ulps),
        bf16("gmh_scores", "bf16, bf16 products", "scores", scores_inputs_bf16, scores_bf16,
             scores_bf16_plain, head_sum_ulps),
        bf16("gmh_scores", "bf16, f32 products", "scores", scores_inputs_bf16, gmh_scores,
             gmh_scores_plain),
        ("gcn_aggregate", "f32", "gcn", gcn_inputs, gcn_aggregate, gcn_aggregate_plain, f32),
        ("gcn_degrees", "f32", "degrees", degrees_inputs, gcn_degrees, gcn_degrees_plain, f32),
        ("gmh_attention", "f32", "gmh", gmh_inputs, gmh_attention, gmh_attention_plain, f32),
        ("gmh_attention", "f32 channels-last adj", "gmh", gmh_inputs_channels_last,
         gmh_attention, gmh_attention_plain, f32),
        ("gmh_projection", "f32 path layout", "proj", proj_inputs, gmh_projection,
         gmh_projection_plain, f32),
        ("gmh_projection", "f32 other layout", "proj", proj_inputs_other_layout,
         gmh_projection, gmh_projection_plain, f32),
        ("channel_agg", "f32", "agg", agg_inputs, channel_agg, channel_agg_plain, f32),
        ("channel_agg", "f32 channels-last adj", "agg", agg_inputs_channels_last,
         channel_agg, channel_agg_plain, f32),
        ("channel_agg", "f32 folded", "agg", agg_inputs, folded(channel_agg),
         folded(channel_agg_plain), f32),
        ("channel_agg", "bf16", "agg", agg_inputs, agg_bf16, agg_bf16_plain, bf16_agg_tol),
        ("channel_agg", "bf16 channels-last adj", "agg", agg_inputs_channels_last,
         agg_bf16, agg_bf16_plain, bf16_agg_tol),
        ("gmh_scores", "f32", "scores", scores_inputs, gmh_scores, gmh_scores_plain, f32),
        ("gmh_scores", "bf16", "scores", scores_inputs,
         functools.partial(gmh_scores, bf16=True),
         functools.partial(gmh_scores_plain, bf16=True), bf16_scores_tol),
    ]


# the output that is a symmetric map, by kernel (phase 3 checks it exactly)
MAP_OUTPUT = {"gmh_attention": 1, "gmh_scores": 0}


def phase_kernels(shapes, dev):
    """Each kernel against its plain version at every case of its shape
    key; above N = 64 (the tiled designs) also a second call on the same
    inputs, which must be bit for bit the first, and the maps exactly
    symmetric."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for kname, variant, key, mk, kern, plain, tol_of in kernel_specs():
        for case in shapes[key] + shapes.get(f"{key}_more", []):
            args = mk(case, gen, dev)
            got = kern(*args)
            tiled = case[2 if key.startswith("gcn") else 3] > 64
            again = kern(*args) if tiled else None
            torch.cuda.synchronize()
            ref = plain(*args)
            tol = tol_of(*args)
            got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
            again = again if again is None or isinstance(again, tuple) else (again,)
            for i, (g, r) in enumerate(zip(got, ref)):
                check(g.shape == r.shape, f"{kname} {case[0]}: shape {g.shape} vs {r.shape}")
                tol_i = tol[i] if isinstance(tol, list) else tol
                abs_err, rel_err, ok = compare(g, r, tol_i)
                more = {}
                if tiled:
                    more["repeat_bit_identical"] = bool(torch.equal(g, again[i]))
                    if MAP_OUTPUT.get(kname) == i:
                        more["symmetric"] = bool(torch.equal(g, g.transpose(1, 2)))
                say("kernels", kernel=kname, variant=variant, case=case[0], output=i,
                    shape="x".join(map(str, g.shape)), max_abs_err=f"{abs_err:.3e}",
                    max_rel_err=f"{rel_err:.3e}", tol=tol_text(tol_i), ok=ok, **more)
                check(ok, f"{kname} ({variant}) {case[0]} output {i} disagrees "
                          "with its plain version")
                check(all(more.values()), f"{kname} ({variant}) {case[0]} output {i}: {more}")
                errs[kname] = max(errs.get(kname, 0.0), abs_err)
    return errs


def phase_models(models, train_adjs, dev):
    """Each network on the card against a float64 CPU copy; ``models`` maps
    a name to (module, launches of one forward, tolerance)."""
    import copy

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import init_flags
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x

    B, N = 128, models["adj"][0].max_node_num
    F = models["x"][0].max_feat_num
    rng = np.random.default_rng(1)
    flags = torch.from_numpy(init_flags(train_adjs, B, rng))
    x = mask_x(torch.from_numpy(rng.standard_normal((B, N, F)).astype(np.float32)), flags)
    adj = mask_adjs(sym(torch.from_numpy(rng.standard_normal((B, N, N)).astype(np.float32))),
                    flags)
    refs = {}
    x64, adj64, flags64 = x.double(), adj.double(), flags.double()
    for name, (model, expect, tol) in models.items():
        cpu = copy.deepcopy(model).cpu().double()
        reset_launches()
        with torch.no_grad():
            got = model(x.to(dev), adj.to(dev), flags.to(dev))
            torch.cuda.synchronize()
            launched = {k: v for k, v in LAUNCHES.items() if v}
            ref = refs[name] = cpu(x64, adj64, flags64)
        check(launched == expect, f"model {name}: launches {launched}, expected {expect}")
        got = got.cpu().double()
        abs_err, rel_err, ok = compare(got, ref, tol)
        at = tuple(int(i) for i in
                   torch.unravel_index((got - ref).abs().argmax(), got.shape))
        say("models", model=name, shape="x".join(map(str, got.shape)),
            launches=json.dumps(launched), max_abs_err=f"{abs_err:.3e}",
            max_rel_err=f"{rel_err:.3e}", worst_at=json.dumps(at),
            card=f"{got[at].item():.6e}", cpu=f"{ref[at].item():.6e}",
            tol=json.dumps(tol), ok=ok)
        if not ok:  # say whether either side is unstable before failing
            with torch.no_grad():
                got2 = model(x.to(dev), adj.to(dev), flags.to(dev)).cpu().double()
                ref2 = cpu(x64, adj64, flags64)
            say("models", model=name, card_repeat_diff=f"{(got2 - got).abs().max().item():.3e}",
                cpu_repeat_diff=f"{(ref2 - ref).abs().max().item():.3e}",
                repeat_max_abs_err=f"{(got2 - ref2).abs().max().item():.3e}")
        check(ok, f"{name} on the card disagrees with the CPU copy")
    sep = (refs["adj_fused_fast"] - refs["adj_fused_f32"]).abs().max().item()
    say("models", bf16_vs_f32_scores_on_cpu=f"{sep:.3e}",
        fast_tol=json.dumps(BF16_MODEL_TOL))
    check(sep > BF16_MODEL_TOL["atol"],
          "the fast network's tolerance cannot tell bf16 from f32 scores")


def phase_grid_x(dev):
    """ScoreNetworkX of GRID_CONFIG (B = 8, N = 361, depth 5, nhid 32,
    seeded weights) on the card against a float64 CPU copy: each GCN layer
    cuts its graphs into row tiles after a ``gcn_degrees`` pass.  The
    launch counts are set to 0 just before and read just after; returns
    them."""
    import copy

    import numpy as np
    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x
    from ccsd_tpu_torch.utils.config import get_config

    c = get_config(GRID_CONFIG, seed=0, folder=HERE)
    model = load_model(load_model_params(c)[0], generator=torch.Generator().manual_seed(3))
    model = model.to(dev).eval()
    B, N, F = int(c.data.batch_size), int(c.data.max_node_num), int(c.data.max_feat_num)
    rng = np.random.default_rng(4)
    flags = torch.from_numpy(
        (np.arange(N)[None] < rng.integers(N - 60, N + 1, (B, 1))).astype(np.float32))
    x = mask_x(torch.from_numpy(rng.standard_normal((B, N, F)).astype(np.float32)), flags)
    adj = mask_adjs(sym(torch.from_numpy((rng.random((B, N, N)) < 4 / N).astype(np.float32))),
                    flags)
    depth = int(c.model.depth)
    expect = {"gcn_aggregate": depth, "gcn_degrees": depth}
    reset_launches()
    with torch.no_grad():
        got = model(x.to(dev), adj.to(dev), flags.to(dev))
        torch.cuda.synchronize()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        ref = copy.deepcopy(model).cpu().double()(x.double(), adj.double(), flags.double())
    check(launched == expect, f"grid ScoreNetworkX: launches {launched}, expected {expect}")
    abs_err, rel_err, ok = compare(got.cpu().double(), ref, MODEL_TOL)
    say("grid", model=f"{GRID_CONFIG} ScoreNetworkX", shape="x".join(map(str, got.shape)),
        launches=json.dumps(launched), max_abs_err=f"{abs_err:.3e}",
        max_rel_err=f"{rel_err:.3e}", tol=json.dumps(MODEL_TOL), ok=ok)
    check(ok, "grid ScoreNetworkX on the card disagrees with the CPU copy")
    return launched


def grid_inputs(c, B, seed):
    """(x, adj, flags) of B graphs at config c's N: each graph's first
    N - 60 to N nodes present, standard-normal features, a 0/1 adjacency
    of mean degree 4 (grid's), masked."""
    import numpy as np
    import torch
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x

    N, F = int(c.data.max_node_num), int(c.data.max_feat_num)
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy(
        (np.arange(N)[None] < rng.integers(N - 60, N + 1, (B, 1))).astype(np.float32))
    x = mask_x(torch.from_numpy(rng.standard_normal((B, N, F)).astype(np.float32)), flags)
    adj = mask_adjs(sym(torch.from_numpy((rng.random((B, N, N)) < 4 / N).astype(np.float32))),
                    flags)
    return x, adj, flags


def phase_grid_a(dev):
    """GRID_CONFIG's ScoreNetworkA (B = GRID_NET_B, N = 361, 7
    AttentionLayers, seeded weights) unfused, fused f32 and fused fast, each
    on the card against a float64 CPU copy, within the larger of phase 4's
    tolerance and GRID_F32_FACTOR times the CPU f32 copy's own distance
    from float64, and with exact launch counts (every layer: gcn_degrees,
    then gmh_projection and gmh_attention, or channel_agg and gmh_scores);
    returns each variant's launches."""
    import copy

    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
    from ccsd_tpu_torch.utils.config import get_config

    c = get_config(GRID_CONFIG, seed=0, folder=HERE)
    defs = dict(zip(("x", "adj"), load_model_params(c)))
    base = load_model(defs["adj"], generator=torch.Generator().manual_seed(3))
    x, adj, flags = grid_inputs(c, GRID_NET_B, 5)
    L = int(c.model.num_layers)
    out = {}
    for name, d, expect, tol in (
            ("unfused", defs["adj"], {"gcn_degrees": L, "gmh_projection": L,
                                      "gmh_attention": L}, MODEL_TOL),
            ("fused_f32", with_fused(defs, fast=False)["adj"],
             {"gcn_degrees": L, "channel_agg": L, "gmh_scores": L}, MODEL_TOL),
            ("fused_fast", with_fused(defs, fast=True)["adj"],
             {"gcn_degrees": L, "channel_agg": L, "gmh_scores": L}, BF16_MODEL_TOL)):
        model = load_model(d).eval()
        model.load_state_dict(base.state_dict())
        card = copy.deepcopy(model).to(dev)
        reset_launches()
        with torch.no_grad():
            got = card(x.to(dev), adj.to(dev), flags.to(dev))
            torch.cuda.synchronize()
            launched = {k: v for k, v in LAUNCHES.items() if v}
            cpu32 = model(x, adj, flags).double()
            ref = model.double()(x.double(), adj.double(), flags.double())
        check(launched == expect, f"grid ScoreNetworkA {name}: launches {launched}, "
                                  f"expected {expect}")
        cpu_err = (cpu32 - ref).abs().max().item()
        tol = dict(tol, atol=max(tol["atol"], GRID_F32_FACTOR * cpu_err))
        abs_err, rel_err, ok = compare(got.cpu().double(), ref, tol)
        say("grid", model=f"{GRID_CONFIG} ScoreNetworkA {name}",
            shape="x".join(map(str, got.shape)), launches=json.dumps(launched),
            max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel_err:.3e}",
            cpu_f32_max_abs_err=f"{cpu_err:.3e}", tol=json.dumps(tol), ok=ok)
        check(ok, f"grid ScoreNetworkA {name} on the card disagrees with the CPU copy")
        out[name] = launched
    return out


def sample_config(steps=None, fused=True, name="community_small"):
    """The named config (community_small unless said); ``fused=False``
    sets ``sample.fused: false``."""
    from ccsd_tpu_torch.utils.config import AttrDict, get_config

    config = get_config(name, seed=0, folder=HERE)
    ckpts = sorted(glob.glob(os.path.join(HERE, "checkpoints", name, "*.ckpt.pkl")))
    if ckpts:
        config.ckpt = os.path.basename(ckpts[0])[: -len(".ckpt.pkl")]
    config = AttrDict(config.to_dict())
    if steps is not None:
        for k in ("x", "adj"):
            config.sde[k].num_scales = steps
    if not fused:
        config.sample.fused = False
    return config


def smoke_sampler(config, train_adjs, weights=None):
    """``Sampler`` on the default device (CUDA).  ``weights``, a port
    checkpoint, gives the networks its EMA weights (grid: grid_small's run,
    whose networks have grid's widths).  Otherwise, without a checkpoint in
    the config, the weights are the port's seeded Glorot init, with the
    adjacency network's last layer scaled by ``SEEDED_ADJ_HEAD_SCALE``: at
    full Glorot scale untrained weights feed the adjacency back into itself
    through ``pow_tensor`` and community_small's reverse diffusion overflows
    after ~230 of the 1000 steps, in the JAX package as in the port."""
    import torch
    from ccsd_tpu_torch.sampling.sampler import Sampler
    from ccsd_tpu_torch.training.checkpoint import load_port_ckpt, state_dict_from_ckpt

    class SmokeSampler(Sampler):
        def load_models(self):
            configt, models, source = super().load_models()
            if weights:
                ckpt = load_port_ckpt(weights, map_location="cpu")
                for n, m in models.items():
                    m.load_state_dict(state_dict_from_ckpt(ckpt, n, m, True))
                source = f"EMA weights of {os.path.relpath(weights, HERE)}"
            elif not self.config.get("ckpt"):
                with torch.no_grad():
                    models["adj"].final.linears[-1].weight.mul_(SEEDED_ADJ_HEAD_SCALE)
                source += f", adjacency head x {SEEDED_ADJ_HEAD_SCALE}"
            return configt, models, source

    return SmokeSampler(config, train_adjs)


def sample_launches(config, fused, rounds=1):
    """The exact launches of ``rounds`` sampling rounds: every score
    evaluation (one a predictor step, one a corrector step; one a step of
    the S4 solver) launches
    ``gcn_aggregate`` once a ScoreNetworkX layer, and ``channel_agg`` and
    ``gmh_scores`` (fused) or ``gmh_attention`` (unfused) once an
    AttentionLayer.  Above N = 64 (grid) each of those layers also launches
    ``gcn_degrees`` first, and an unfused AttentionLayer ``gmh_projection``
    between the two."""
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.gcn import is_tiled
    from ccsd_tpu_torch.kernels.gmh_attention import MAX_N

    steps = int(config.sde.adj.num_scales)
    if config.sampler.predictor == "S4":  # one evaluation a step, whatever the corrector
        evals = rounds * steps
    else:
        evals = rounds * steps * (int(config.sampler.n_steps) + 1
                                  if config.sampler.corrector == "Langevin" else 1)
    N = int(config.data.max_node_num)
    depth, L = int(config.model.depth), int(config.model.num_layers)
    per_layer = ["channel_agg", "gmh_scores"] if fused else ["gmh_attention"]
    if N > MAX_N and not fused:
        per_layer.append("gmh_projection")
    if "GMH" in str(config.model.x):  # ScoreNetworkX_GMH: depth AttentionLayers (N <= 64)
        depth, L = 0, L + depth
    expect = {k: 0 for k in LAUNCHES}
    expect["gcn_aggregate"] = evals * depth
    for k in per_layer:
        expect[k] = evals * L
    expect["gcn_degrees"] = evals * (depth * is_tiled(N) + L * (N > MAX_N))
    return expect


def check_graphs(res, config, graphs, path):
    """A sampler's result on the card: ``graphs`` finite graphs of the
    config's shapes, quantized, symmetric, zero-diagonal, with no edge or
    feature on an absent node."""
    import numpy as np

    adj, x, flags = res["adj"], res["x"], res["flags"]
    N, F = int(config.data.max_node_num), int(config.data.max_feat_num)
    check(res["device"].startswith("cuda"), f"{path}: sampler ran on {res['device']}")
    check(adj.shape == (graphs, N, N) and x.shape == (graphs, N, F),
          f"{path}: shapes adj {adj.shape}, x {x.shape}")
    check(res["finite"], f"{path}: non-finite sampler output")
    check(set(np.unique(adj)) <= {0.0, 1.0}, f"{path}: adjacency not quantized")
    check(np.array_equal(adj, adj.transpose(0, 2, 1)), f"{path}: adjacency not symmetric")
    check(not adj[:, np.arange(N), np.arange(N)].any(), f"{path}: non-zero diagonal")
    absent = flags == 0
    check(not adj[absent].any() and not adj.transpose(0, 2, 1)[absent].any(),
          f"{path}: edges on absent nodes")
    check(not x[absent].any(), f"{path}: features on absent nodes")


def sample_once(train_adjs, fused, name="community_small", graphs=128, phase="sample",
                weights=None, steps=None):
    """One sample of ``graphs`` graphs (one round of the config's batch;
    the config's 1000 steps unless ``steps`` says) after a 10-step warm-up,
    ``weights`` as ``smoke_sampler`` takes them; checks the graphs and the
    exact launch counts; returns the counts."""
    import numpy as np
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches

    smoke_sampler(sample_config(steps=10, fused=fused, name=name),
                  train_adjs, weights).sample(graphs)  # warm-up
    config = sample_config(steps=steps, fused=fused, name=name)
    steps = int(config.sde.adj.num_scales)
    expect = sample_launches(config, fused)

    sampler = smoke_sampler(config, train_adjs, weights)
    reset_launches()
    res = sampler.sample(graphs)
    launches = dict(LAUNCHES)

    path = "default (sample.fused, sample.fast on)" if fused else "sample.fused: false"
    path = f"{name} {path}"
    check_graphs(res, config, graphs, path)
    check(launches == expect, f"{path}: launches {launches}, expected exactly {expect}")
    adj, flags = res["adj"], res["flags"]
    B = adj.shape[0]
    edges = adj.sum((1, 2)) / 2
    say(phase, path=repr(path), graphs=B, steps=steps, predictor=config.sampler.predictor,
        corrector=config.sampler.corrector,
        seconds=f"{res['sampling_time']:.3f}", mean_edges=f"{edges.mean():.3f}",
        mean_nodes=f"{flags.sum(-1).mean():.3f}", weights=repr(res["weights"]),
        launches=json.dumps(launches), expected=json.dumps(expect))
    say("steps_per_s", path=repr(path), steps_per_s=f"{res['steps_per_s']:.2f}",
        card=repr(smi_name_power()))
    return launches


def phase_sample(train_adjs, name="community_small", graphs=128, phase="sample",
                 weights=None, steps=None):
    """The default (fused fast) sample, then the unfused one; returns
    {path: launches} of the two runs."""
    return {f"{name} {p}": sample_once(train_adjs, fused, name, graphs, phase, weights, steps)
            for p, fused in (("default", True), ("unfused", False))}


# ----------------------------------------------------------------- train --

NAMES = ("x", "adj")


def train_shapes(models, B):
    """The backward kernels' cases of the training path at batch B, as the
    networks give them, with what each call asks for: ScoreNetworkX's first
    layer takes the noisy input (no dx) and no layer's adjacency needs a
    gradient; ScoreNetworkA's first layer takes the noisy input and its
    powers, the later ones the previous layer's x and (channels-last)
    maps, both with gradients.

    gcn_bwd: (name, B, N, F_in, F_out, loop, need_x, need_adj); gmh_bwd:
    (name, B, C, N, F_in, attn, F_out, H, need_x, need_adj).
    """
    from ccsd_tpu_torch.kernels.gmh_attention import head_split

    N = models["adj"].max_node_num
    gcn = [(f"x.layers.{k}", B, N, l.in_channels, l.out_channels, l.loop, k > 0, False)
           for k, l in enumerate(models["x"].layers)]
    gmh = []
    for k, layer in enumerate(models["adj"].layers):
        a = layer.attn[0]
        H = head_split(a.attn_dim, a.num_heads)[0]
        gmh.append((f"adj.layers.{k}", B, len(layer.attn), N, a.in_dim, a.attn_dim,
                    a.out_dim, H, k > 0, k > 0))
    return {"gcn_bwd": gcn, "gmh_bwd": gmh}


def more_train_shapes():
    """``gcn_bwd_more`` and ``gmh_bwd_more`` cases: the backward kernels at
    the layer shapes of EXTRA_CONFIGS (N = 49; head widths 8 and 6), of
    grid (N = 361: the tiled designs) and of grid at N = RAGGED_N (a ragged
    last tile), each config's first and later layer asking for what its
    training path asks (train_shapes); checked in the train_kernels phase
    and timed, out of the means.  ``score_grad`` (grid's attention layers)
    and ``score_grad_more`` (at RAGGED_N): the cases of ``gmh_score_grad``,
    a launch of the tiled attention backward; ``bwd_layout`` and
    ``bwd_rows`` (with ``_more``): the same cases of its layout pass and of
    its row-tile kernel."""
    from ccsd_tpu_torch.kernels.gmh_attention import head_split
    from ccsd_tpu_torch.utils.config import get_config

    gcn, gmh = [], []
    configs = [(name, get_config(name, seed=0, folder=HERE)) for name in EXTRA_CONFIGS]
    configs += [(GRID_CONFIG, get_config(GRID_CONFIG, seed=0, folder=HERE)),
                (f"{GRID_CONFIG}.n{RAGGED_N}", ragged_config())]
    for name, c in configs:
        m, B, N = c.model, int(c.data.batch_size), int(c.data.max_node_num)
        F = int(c.data.max_feat_num)
        for k, Fi in enumerate((F, m.nhid)):
            gcn.append((f"{name}.x.layers.{k}", B, N, Fi, m.nhid, 1.0, k > 0, False))
        for k, (Fi, A, C) in enumerate(((F, m.nhid, m.c_init), (m.nhid, m.adim, m.c_hid))):
            H = head_split(A, m.num_heads)[0]
            gmh.append((f"{name}.layers.{k}", B, C, N, Fi, A, m.nhid, H, k > 0, k > 0))
    grid = [case for case in gmh if case[0].startswith(f"{GRID_CONFIG}.layers.")]
    ragged = [case for case in gmh if case[0].startswith(f"{GRID_CONFIG}.n{RAGGED_N}.")]
    return {"gcn_bwd_more": gcn, "gmh_bwd_more": gmh, "score_grad": grid,
            "score_grad_more": ragged, "bwd_layout": grid, "bwd_layout_more": ragged,
            "bwd_rows": grid, "bwd_rows_more": ragged}


def padded(adj, gen):
    """adj (B, ..., N, N) with each graph's nodes from 12 to N present and
    the rest zeroed, as the training batches' absent nodes are (their rows
    sum to exactly 1 after the loop: the tie of the degree clamp)."""
    import torch

    B, N = adj.shape[0], adj.shape[-1]
    n = torch.randint(12, N + 1, (B,), generator=gen, device=adj.device)
    f = (torch.arange(N, device=adj.device)[None] < n[:, None]).to(adj.dtype)
    f = f.reshape(B, *([1] * (adj.dim() - 3)), N)
    return adj * f[..., :, None] * f[..., None, :]


def gcn_bwd_inputs(case, gen, dev):
    import torch

    _, B, N, Fi, Fo, loop, need_x, need_adj = case
    x = torch.randn(B, N, Fi, generator=gen, device=dev)
    adj = padded(sym(torch.randn(B, N, N, generator=gen, device=dev)), gen)
    g = torch.randn(B, N, Fo, generator=gen, device=dev)
    return (x, adj, glorot((Fi, Fo), gen, dev), g, loop, True, need_x, need_adj)


def gmh_bwd_inputs(case, gen, dev):
    """The adjacency in the layer's layout (gmh_path_inputs), dL/dA as the
    strided slice the layer's concat of [maps | adjacency] hands back."""
    import torch

    _, B, C, N, Fi, A, O, H, need_x, need_adj = case
    x, adj, *w, _, _ = gmh_path_inputs((case[0], B, C, N, Fi, A, O, H), gen, dev)
    adj = padded(adj, gen)
    if not first_layer(case):
        adj = channels_last(adj)
    gv = torch.randn(B, N, C * O, generator=gen, device=dev)
    ga = torch.randn(B, N, N, 2 * C, generator=gen, device=dev)[..., :C]
    return (x, adj, *w, gv, ga, H, O, 1.0, True, need_x, need_adj)


def grad_compare(got, ref, rel):
    """(max abs err, max err over rel's scale, within) of a gradient:
    |got - ref| <= rel (|ref| + max |ref|), elementwise; the max |ref|
    term scales the bound by the gradient's magnitude, where entries
    cancel."""
    diff = (got - ref).abs()
    scale = ref.abs() + ref.abs().max()
    worst = (diff / scale.clamp_min(1e-30)).max().item()
    return diff.max().item(), worst, bool((diff <= rel * scale).all() and got.isfinite().all())


def gmh_bwd_inputs_other_layout(case, gen, dev):
    """As gmh_bwd_inputs, the adjacency in the other layout than the path's
    (channels-last for the first layer, contiguous for a later one)."""
    x, adj, *rest = gmh_bwd_inputs(case, gen, dev)
    return (x, adj.contiguous() if not first_layer(case) else channels_last(adj), *rest)


def score_grad_inputs(case, gen, dev):
    """(Q | K, gm, heads, F_out) of a gmh_bwd case: Q and K standard normal
    (head sums of ~1 / sqrt(F_out) scale, as the layer's), gm the layout
    pass's symmetrised dL/dA (formed by the plain version) of the strided
    slice the path hands back."""
    import torch
    from ccsd_tpu_torch.kernels.gmh_attention import grad_sym_plain, map_row

    _, B, C, N, Fi, A, O, H, _, _ = case
    qk = torch.randn(B, C, N, 2 * A, generator=gen, device=dev)
    ga = torch.randn(B, N, N, 2 * C, generator=gen, device=dev)[..., :C]
    gm = ga.new_zeros(B, C, N, map_row(N))
    gm[..., :N] = grad_sym_plain(ga)
    return (qk, gm, H, O)


def layout_inputs(case, gen, dev):
    """(adj, dL/dA) of a gmh_bwd case, as gmh_bwd_inputs makes them: the
    adjacency in the layer's layout, dL/dA the strided slice."""
    x, adj, *w, gv, ga, H, O, loop, add_loop, need_x, need_adj = gmh_bwd_inputs(case, gen, dev)
    return (adj, ga)


def row_tile_inputs(case, gen, dev):
    """The row-tile kernel's arguments for a gmh_bwd case: its inputs from
    the launches before it on the card (degrees, Q | K, the layout pass,
    gQ | gK), as the tiled call gives them."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees
    from ccsd_tpu_torch.kernels.gmh_attention import (gmh_bwd_layout, gmh_projection,
                                                      gmh_score_grad)

    x, adj, *w, gv, ga, H, O, loop, add_loop, need_x, need_adj = gmh_bwd_inputs(case, gen, dev)
    deg = gcn_degrees(adj, add_loop, loop)
    qk, _ = gmh_projection(x, adj, deg, *w, loop, add_loop)
    ac, gm = gmh_bwd_layout(adj, ga)
    gqk = gmh_score_grad(qk, gm, H, O)
    return (x, adj, *w, gqk, gv, deg, ac, loop, add_loop, need_x, need_adj)


def phase_train_kernels(shapes, dev):
    """Each backward kernel against its plain backward on the card, at the
    training path's shapes (and ``<key>_more``'s: above N = 64 the tiled
    designs), every gradient the call gives, ``gmh_attention_bwd`` in both
    adjacency layouts, and ``gmh_score_grad`` (a launch of the tiled
    attention backward) against its plain version; each kernel called
    twice on the same inputs, which must give the same bits (the sums over
    blocks run in a fixed order); at grid's attention layers and at
    RAGGED_N also the tiled design's other two kernels alone: the layout
    pass (exactly its plain version) and the row-tile kernel (every
    gradient), and the card's grant of ``gmh_score_grad``'s cluster."""
    import torch
    from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_bwd, gcn_aggregate_bwd_plain
    from ccsd_tpu_torch.kernels.build import kernel_fn
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention_bwd,
        gmh_attention_bwd_plain,
        gmh_attention_bwd_tiled,
        gmh_attention_bwd_tiled_plain,
        gmh_bwd_layout,
        gmh_bwd_layout_plain,
        gmh_score_grad,
        gmh_score_grad_plain,
        score_tiles,
    )

    names = {"gcn_aggregate_bwd": ("dx", "dadj", "dweight", "dbias"),
             "gmh_attention_bwd": ("dx", "dadj", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv")}
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {}
    for kname, variant, key, mk, kern, plain in (
            ("gcn_aggregate_bwd", "path", "gcn_bwd", gcn_bwd_inputs, gcn_aggregate_bwd,
             gcn_aggregate_bwd_plain),
            ("gmh_attention_bwd", "path layout", "gmh_bwd", gmh_bwd_inputs, gmh_attention_bwd,
             gmh_attention_bwd_plain),
            ("gmh_attention_bwd", "other layout", "gmh_bwd", gmh_bwd_inputs_other_layout,
             gmh_attention_bwd, gmh_attention_bwd_plain)):
        for case in shapes[key] + shapes.get(f"{key}_more", []):
            args = mk(case, gen, dev)
            got = kern(*args)
            again = kern(*args)
            torch.cuda.synchronize()
            same = all((g is None and a is None) or torch.equal(g, a) for g, a in zip(got, again))
            say("train_kernels", kernel=kname, variant=variant, case=case[0],
                repeat_bit_identical=same)
            check(same, f"{kname} {case[0]}: two calls on the same inputs differ")
            ref = plain(*args)
            for out, g, r in zip(names[kname], got, ref):
                check((g is None) == (r is None), f"{kname} {case[0]}: {out} given by one side")
                if g is None:
                    continue
                check(g.shape == r.shape, f"{kname} {case[0]}: {out} {g.shape} vs {r.shape}")
                abs_err, worst, ok = grad_compare(g, r, BWD_REL_TOL)
                say("train_kernels", kernel=kname, variant=variant, case=case[0], grad=out,
                    shape="x".join(map(str, g.shape)), max_abs_err=f"{abs_err:.3e}",
                    max_scaled_err=f"{worst:.3e}", rel_tol=BWD_REL_TOL, ok=ok)
                check(ok, f"{kname} {case[0]}: {out} disagrees with the plain backward")
                errs[kname] = max(errs.get(kname, 0.0), abs_err)
    for case in shapes["score_grad"] + shapes["score_grad_more"]:
        args = score_grad_inputs(case, gen, dev)
        got, again = gmh_score_grad(*args), gmh_score_grad(*args)
        torch.cuda.synchronize()
        abs_err, worst, ok = grad_compare(got, gmh_score_grad_plain(*args), BWD_REL_TOL)
        same = torch.equal(got, again)
        say("train_kernels", kernel="gmh_score_grad", case=case[0],
            shape="x".join(map(str, got.shape)), max_abs_err=f"{abs_err:.3e}",
            max_scaled_err=f"{worst:.3e}", rel_tol=BWD_REL_TOL, repeat_bit_identical=same,
            ok=ok)
        check(ok and same, f"gmh_score_grad {case[0]}: disagrees with its plain version or "
                           "differs between two calls")
        errs["gmh_score_grad"] = max(errs.get("gmh_score_grad", 0.0), abs_err)
        # its cluster of every row tile of a (graph, channel), granted
        N, A, H = case[3], case[5], case[7]
        held = kernel_fn("gmh_attention_bwd", "gmh_score_grad_max_clusters")(N, A, H)
        say("train_kernels", kernel="gmh_score_grad", case=case[0],
            cluster_blocks=score_tiles(N), max_active_clusters=held)
        check(held > 0, f"gmh_score_grad {case[0]}: a cluster of {score_tiles(N)} blocks is "
                        f"not granted ({held})")
        # the layout pass, exactly its plain version
        args = layout_inputs(case, gen, dev)
        got, again = gmh_bwd_layout(*args), gmh_bwd_layout(*args)
        torch.cuda.synchronize()
        want = gmh_bwd_layout_plain(*args)
        same = all(g is None and a is None or torch.equal(g, a) for g, a in zip(got, again))
        ok = all(g is None and w is None or (g is not None and w is not None
                                             and torch.equal(g, w))
                 for g, w in zip(got, want))
        say("train_kernels", kernel="gmh_bwd_layout", case=case[0], copies_adj=got[0] is not None,
            exact=ok, repeat_bit_identical=same)
        check(ok and same, f"gmh_bwd_layout {case[0]}: differs from its plain version or "
                           "between two calls")
        errs["gmh_bwd_layout"] = 0.0
        # the row-tile kernel alone, every gradient the call gives
        args = row_tile_inputs(case, gen, dev)
        got, again = gmh_attention_bwd_tiled(*args), gmh_attention_bwd_tiled(*args)
        torch.cuda.synchronize()
        same = all((g is None and a is None) or torch.equal(g, a) for g, a in zip(got, again))
        check(same, f"gmh_attention_bwd_tiled {case[0]}: two calls differ")
        for out, g, r in zip(names["gmh_attention_bwd"], got,
                             gmh_attention_bwd_tiled_plain(*args)):
            check((g is None) == (r is None), f"gmh_attention_bwd_tiled {case[0]}: {out}")
            if g is None:
                continue
            abs_err, worst, ok = grad_compare(g, r, BWD_REL_TOL)
            say("train_kernels", kernel="gmh_attention_bwd_tiled", case=case[0], grad=out,
                max_abs_err=f"{abs_err:.3e}", max_scaled_err=f"{worst:.3e}",
                rel_tol=BWD_REL_TOL, repeat_bit_identical=same, ok=ok)
            check(ok, f"gmh_attention_bwd_tiled {case[0]}: {out} disagrees with its plain "
                      "version")
            errs["gmh_attention_bwd_tiled"] = max(errs.get("gmh_attention_bwd_tiled", 0.0),
                                                  abs_err)
    return errs


def train_config(folder, name, epochs, data="community_small"):
    """The training config of ``data`` (community_small unless said), the
    run's outputs under folder."""
    from ccsd_tpu_torch.utils.config import AttrDict, get_config

    config = AttrDict(get_config(data, seed=0, folder=HERE).to_dict())
    config.folder = folder
    config.train.name, config.train.num_epochs = name, epochs
    config.train.save_interval, config.train.print_interval = epochs, 50
    return config


def phase_train_grads(config, train_adjs, dev, graphs=None, phase="train_grads"):
    """The gradients of the full loss (both networks, seeded weights) on the
    card against a float64 CPU copy, on the train split's first ``graphs``
    graphs (all: community_small's train batch, B = 80) and the same draws,
    within the bound an f32 CPU copy of the same step sets
    (GRAD_F32_FACTOR); returns the launches of the card's step."""
    import copy

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import init_features, split
    from ccsd_tpu_torch.diffusion.losses import get_sde_loss_fn
    from ccsd_tpu_torch.diffusion.sde import load_sde
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x, node_flags

    g = torch.Generator().manual_seed(5)
    models = {n: load_model(d, generator=g) for n, d in zip(NAMES, load_model_params(config))}
    f64 = {n: copy.deepcopy(m).double() for n, m in models.items()}
    f32 = {n: copy.deepcopy(m) for n, m in models.items()}
    card = {n: m.to(dev) for n, m in models.items()}
    adj = train_adjs[split(len(train_adjs), float(config.data.test_split))[0]][:graphs]
    x = torch.from_numpy(init_features(config.data.init, adj, int(config.data.max_feat_num)))
    adj = torch.from_numpy(adj)
    flags = node_flags(adj)
    rng = np.random.default_rng(6)
    eps = float(config.train.eps)
    t = torch.from_numpy(rng.uniform(eps, 1.0, adj.shape[0]).astype(np.float32))
    z_x = mask_x(torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)), flags)
    z_adj = mask_adjs(sym(torch.from_numpy(rng.standard_normal(adj.shape).astype(np.float32))),
                      flags)
    batch = (x, adj, t, z_x, z_adj)
    loss = get_sde_loss_fn(*[load_sde(config.sde[n]) for n in NAMES],
                           reduce_mean=config.train.reduce_mean, eps=eps)
    reset_launches()
    on_card = loss.losses(card["x"], card["adj"], *(v.to(dev) for v in batch))
    sum(on_card).backward()
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    ref = loss.losses(f64["x"], f64["adj"], *(v.double() for v in batch))
    sum(ref).backward()
    sum(loss.losses(f32["x"], f32["adj"], *batch)).backward()
    for n, c, r in zip(NAMES, on_card, ref):
        say(phase, loss=n, card=f"{c.item():.6e}", cpu_float64=f"{r.item():.6e}")
    def grad(p):  # a parameter outside the loss (the last layer's node head) has none
        # on the plain path and a zero one from a backward kernel: zero, as under jax.grad
        return (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().double()

    for n in NAMES:
        params = [(name, grad(p), grad(q), grad(r)) for (name, p), q, r in
                  zip(card[n].named_parameters(), f32[n].parameters(), f64[n].parameters())]
        cpu32 = max(grad_compare(q, r, 0.0)[1] for _, _, q, r in params)
        rel = max(GRAD_REL_TOL, GRAD_F32_FACTOR * cpu32)
        worst = (0.0, 0.0, "")
        for name, p, _, r in params:
            abs_err, scaled, ok = grad_compare(p, r, rel)
            check(ok, f"{n}.{name}: gradient on the card disagrees with the CPU copy "
                      f"(max abs err {abs_err:.3e}, scaled {scaled:.3e}, bound {rel:.3e})")
            worst = max(worst, (scaled, abs_err, name))
        c, r = on_card[NAMES.index(n)].item(), ref[NAMES.index(n)].item()
        check(abs(c - r) <= rel * abs(r), f"loss_{n} on the card disagrees with the CPU copy")
        say(phase, network=n, params=len(params), worst_param=worst[2],
            max_scaled_err=f"{worst[0]:.3e}", max_abs_err=f"{worst[1]:.3e}",
            cpu_f32_max_scaled_err=f"{cpu32:.3e}", bound=f"{rel:.3e}",
            launches=json.dumps(launched))
    return launched


def phase_train(config, train_adjs, dev):
    """The full-width training run and its checks; returns the launch counts
    of the 200-epoch run."""
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import Sampler
    from ccsd_tpu_torch.training.trainer import Trainer

    folder = os.path.join(HERE, "build", "smoke_train")
    shutil.rmtree(folder, ignore_errors=True)
    depth, L = int(config.model.depth), int(config.model.num_layers)
    # an epoch: one train step (forward and backward) and one test loss
    per_epoch = {"gcn_aggregate": 2 * depth, "gmh_attention": 2 * L,
                 "gcn_aggregate_bwd": depth, "gmh_attention_bwd": L}

    trainer = Trainer(train_config(folder, "smoke", TRAIN_EPOCHS), adjs=train_adjs)
    check(trainer.device.type == "cuda", f"the trainer runs on {trainer.device}")
    check([len(trainer.train_loader), len(trainer.test_loader)] == [1, 1],
          "an epoch of community_small is not one train and one test batch")
    # the run in two calls of train(): the first ends at the resume check's
    # mid-run epoch with a checkpoint, kept aside; the state goes on in memory
    reset_launches()
    t0 = time.perf_counter()
    trainer.config.train.num_epochs = TRAIN_EPOCHS // 2
    name = trainer.train()
    mid = trainer.checkpoint_path(f"{name}_mid")
    shutil.copyfile(trainer.checkpoint_path(f"{name}_final"), mid)
    trainer.config.train.num_epochs = TRAIN_EPOCHS
    trainer.train()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    expect = {k: TRAIN_EPOCHS * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"train: launches {launches}, expected exactly {expect}")
    hist = np.asarray(trainer.history["train"])
    test = np.asarray(trainer.history["test"])
    first, end = hist[0], hist[-10:].mean(axis=0)
    say("train", epochs=trainer.epoch, steps=trainer.step, seconds=f"{seconds:.3f}",
        loss_x=f"{first[0]:.4f}->{hist[-1][0]:.4f}", loss_adj=f"{first[1]:.4f}->{hist[-1][1]:.4f}",
        test_loss_x=f"{test[0][0]:.4f}->{test[-1][0]:.4f}",
        test_loss_adj=f"{test[0][1]:.4f}->{test[-1][1]:.4f}",
        launches_per_epoch=json.dumps({k: v // TRAIN_EPOCHS for k, v in launches.items() if v}))
    say("train_steps_per_s", steps_per_s=f"{trainer.step / seconds:.2f}",
        note="train steps over the wall time of the epoch loops, each epoch one step and "
             "one test loss")
    check(np.isfinite(hist).all() and np.isfinite(test).all(), "non-finite training losses")
    check(bool((end < first).all()), f"losses did not fall: epoch 1 {first}, last ten {end}")

    # the checkpoint through the Sampler: its networks are the trainer's EMA ones
    cfg = train_config(folder, "smoke", TRAIN_EPOCHS)
    cfg.ckpt, cfg.sample.use_ema, cfg.sample.fused = f"{name}_final", True, False
    _, models, source = Sampler(cfg, train_adjs).load_models()
    x, adj = next(iter(trainer.test_loader))  # gathered on the card
    flags = (adj.abs().sum(-1) > 1e-5).float()
    with torch.no_grad():
        for n in NAMES:
            trainer.emas[n].copy_to(trainer.eval_models[n])
            same = torch.equal(models[n](x, adj, flags), trainer.eval_models[n](x, adj, flags))
            check(same, f"the Sampler's {n} network differs from the trainer's EMA network")
    say("train_ckpt", sampler_weights=repr(source), sampler_equals_trainer_ema=True)

    # resume: a new trainer from the mid-run checkpoint, to the end
    resumed = Trainer(train_config(folder, "smoke_resumed", TRAIN_EPOCHS), adjs=train_adjs)
    resumed.load_checkpoint(f"{name}_mid")
    resumed.train()
    for n in NAMES:
        for (k, a), b in zip(trainer.models[n].state_dict().items(),
                             resumed.models[n].state_dict().values()):
            check(torch.equal(a, b), f"resumed {n}.{k} differs from the uninterrupted run")
        for a, b in zip(trainer.emas[n].shadow_params, resumed.emas[n].shadow_params):
            check(torch.equal(a, b), f"resumed EMA of {n} differs from the uninterrupted run")
    check(resumed.history == trainer.history, "resumed losses differ from the uninterrupted run")
    say("train_resume", resumed_from_epoch=TRAIN_EPOCHS // 2, to=resumed.epoch,
        equals_uninterrupted=True)
    return launches, f"{name}_final"


# ------------------------------------------------------------------ eval --

def check_orbits(graphs, what):
    """The orbit library's counts equal the brute-force counter's."""
    from ccsd_tpu_torch.eval.graphs import edge_list
    from ccsd_tpu_torch.eval.orbits import orbit_counts, orbit_counts_py

    for i, g in enumerate(graphs):
        brute = orbit_counts_py(g.num_nodes, edge_list(g).tolist())
        check((orbit_counts(g) == brute).all(),
              f"{what} graph {i}: the orbit library disagrees with the brute-force counter")


def phase_eval(config, ckpt, train_adjs):
    """The evaluation protocol on the train phase's checkpoint ``ckpt``, on
    both sampler paths, with its gates."""
    import math

    from ccsd_tpu_torch.data.cc_codec import convert_graphs_to_CCs
    from ccsd_tpu_torch.data.loader import split
    from ccsd_tpu_torch.eval import cc_stats, orbits, stats
    from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import Sampler, worker_kwargs_from_config

    t0 = time.perf_counter()
    lib = orbits.library()
    say("eval_orbits", library=os.path.relpath(lib._name, HERE),
        seconds=f"{time.perf_counter() - t0:.2f}")
    tr, te = split(len(train_adjs), float(config.data.test_split))
    train, test = train_adjs[tr], train_adjs[te]
    test_graphs = adjs_to_graphs(test)
    check_orbits(test_graphs, "test")
    lift = dict(lifting_procedure=config.data.lifting_procedure,
                lifting_procedure_kwargs=config.data.lifting_procedure_kwargs,
                max_nb_nodes=int(config.data.max_node_num))
    test_ccs = convert_graphs_to_CCs(test_graphs, **lift)
    self_mmd = {**stats.eval_graph_list(test_graphs, test_graphs, *stats.load_eval_settings()),
                **cc_stats.eval_CC_list(test_ccs, test_ccs, worker_kwargs_from_config(config.data))}
    say("eval_self", graphs=len(test_graphs), mmd=json.dumps(self_mmd))
    check(all(v == 0.0 for v in self_mmd.values()), f"test split against itself: {self_mmd}")

    for fused in (True, False):
        path = "default (sample.fused, sample.fast on)" if fused else "sample.fused: false"
        cfg = train_config(os.path.join(HERE, "build", "smoke_train"), "smoke", TRAIN_EPOCHS)
        cfg.ckpt, cfg.sample.fused = ckpt, fused
        sampler = Sampler(cfg, train, test)
        reset_launches()
        res = sampler.sample()
        launches = dict(LAUNCHES)
        expect = sample_launches(cfg, fused)
        check(launches == expect, f"eval {path}: launches {launches}, expected exactly {expect}")
        check(res["adj"].shape == (len(test), 20, 20) and res["finite"],
              f"eval {path}: {res['adj'].shape} graphs, finite {res['finite']}")
        mmds = {**res["mmd"], **res["cc_mmd"]}
        check(len(mmds) == 8 and all(math.isfinite(v) for v in mmds.values()),
              f"eval {path}: MMDs {mmds}")
        check_orbits(adjs_to_graphs(res["adj"]), f"{path} sampled")
        say("eval", path=repr(path), weights=repr(res["weights"]), graphs=len(test),
            batch=int(cfg.data.batch_size), steps=int(cfg.sde.adj.num_scales),
            steps_per_s=f"{res['steps_per_s']:.2f}", mmd=json.dumps(res["mmd"]),
            cc_mmd=json.dumps(res["cc_mmd"]), eval_seconds=f"{res['eval_seconds']:.3f}",
            card=repr(smi_name_power()), launches=json.dumps(launches))


GRID_SMALL = "grid_small"


def grid_small_ckpt_path(name):
    """The path of grid_small's smoke checkpoint ``name``."""
    from ccsd_tpu_torch.training.checkpoint import port_ckpt_path

    return port_ckpt_path(os.path.join(HERE, "build", "smoke_grid_small"), GRID_SMALL, name)


def phase_grid_small_train():
    """grid_small through ``Trainer`` on the dataset it generates from the
    seed (100 graphs: ten train batches of 8 and three test batches, 8, 8
    and 4), cut to GRID_SMALL_EPOCHS epochs: finite losses that fall and
    the exact launches of an epoch; returns (launches, checkpoint name)."""
    import shutil

    import numpy as np
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    folder = os.path.join(HERE, "build", "smoke_grid_small")
    shutil.rmtree(folder, ignore_errors=True)
    config = train_config(folder, "smoke", GRID_SMALL_EPOCHS, data=GRID_SMALL)
    published = int(get_config(GRID_SMALL, seed=0, folder=HERE).train.num_epochs)
    trainer = Trainer(config)
    check(trainer.device.type == "cuda", f"the trainer runs on {trainer.device}")
    n_train, n_test = len(trainer.train_loader), len(trainer.test_loader)
    check([n_train, n_test] == [10, 3], f"{GRID_SMALL}: {n_train} train and {n_test} test "
                                        "batches an epoch, expected 10 and 3")
    depth, L = int(config.model.depth), int(config.model.num_layers)
    per_epoch = {"gcn_aggregate": (n_train + n_test) * depth,
                 "gmh_attention": (n_train + n_test) * L,
                 "gcn_aggregate_bwd": n_train * depth, "gmh_attention_bwd": n_train * L}
    reset_launches()
    t0 = time.perf_counter()
    name = trainer.train()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    expect = {k: GRID_SMALL_EPOCHS * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"{GRID_SMALL} train: launches {launches}, expected exactly "
                              f"{expect}")
    hist, test = np.asarray(trainer.history["train"]), np.asarray(trainer.history["test"])
    first, end = hist[0], hist[-10:].mean(axis=0)
    say("grid_small_train", epochs=trainer.epoch, cut=f"{GRID_SMALL_EPOCHS} of {published}",
        steps=trainer.step, seconds=f"{seconds:.3f}",
        loss_x=f"{first[0]:.4f}->{hist[-1][0]:.4f}", loss_adj=f"{first[1]:.4f}->{hist[-1][1]:.4f}",
        test_loss_x=f"{test[0][0]:.4f}->{test[-1][0]:.4f}",
        test_loss_adj=f"{test[0][1]:.4f}->{test[-1][1]:.4f}",
        launches_per_epoch=json.dumps({k: v // GRID_SMALL_EPOCHS for k, v in launches.items()
                                       if v}))
    say("train_steps_per_s", config=GRID_SMALL, steps_per_s=f"{trainer.step / seconds:.2f}",
        card=repr(smi_name_power()))
    check(np.isfinite(hist).all() and np.isfinite(test).all(), "non-finite training losses")
    check(bool((end < first).all()), f"losses did not fall: epoch 1 {first}, last ten {end}")
    return launches, f"{name}_final"


def phase_grid_small_eval(ckpt):
    """grid_small's checkpoint ``ckpt`` by the JAX protocol cut to its
    first round of 8 graphs (``sample.max_samples``, GRID_SMALL_EVAL_GRAPHS;
    the protocol's three rounds took ~165 s of the smoke's time), its EMA
    weights (the config's ``sample.use_ema: true``), Reverse + Langevin,
    on both paths: exact launch counts, the graphs scored against the 20
    test graphs, eight finite MMDs; returns {path: launches}."""
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import Sampler, sampling_rounds

    out = {}
    for fused in (True, False):
        path = "default (sample.fused, sample.fast on)" if fused else "sample.fused: false"
        cfg = train_config(os.path.join(HERE, "build", "smoke_grid_small"), "smoke",
                           GRID_SMALL_EPOCHS, data=GRID_SMALL)
        cfg.ckpt, cfg.sample.fused = ckpt, fused
        cfg.sample.max_samples = GRID_SMALL_EVAL_GRAPHS
        check(cfg.sample.use_ema and cfg.sampler.predictor == "Reverse",
              f"{GRID_SMALL} samples with use_ema {cfg.sample.use_ema}, predictor "
              f"{cfg.sampler.predictor}")
        adjs = generated_adjs(GRID_SMALL, int(cfg.get("seed", 42)), int(cfg.data.max_node_num))
        tr, te = split(len(adjs), float(cfg.data.test_split))
        sampler = Sampler(cfg, adjs[tr], adjs[te])
        batch, rounds = sampling_rounds(int(cfg.data.batch_size), len(adjs[te]),
                                        max_samples=GRID_SMALL_EVAL_GRAPHS)
        reset_launches()
        res = sampler.sample()
        launches = dict(LAUNCHES)
        expect = sample_launches(cfg, fused, rounds)
        check(launches == expect, f"{GRID_SMALL} eval {path}: launches {launches}, "
                                  f"expected exactly {expect}")
        N = int(cfg.data.max_node_num)
        check(res["adj"].shape == (GRID_SMALL_EVAL_GRAPHS, N, N) and res["finite"],
              f"{GRID_SMALL} eval {path}: {res['adj'].shape} graphs, finite {res['finite']}")
        check("ema" in res["weights"], f"{GRID_SMALL} sampled from {res['weights']}")
        mmds = {**res["mmd"], **(res["cc_mmd"] or {})}
        check(len(mmds) == 8 and all(math.isfinite(v) for v in mmds.values()),
              f"{GRID_SMALL} eval {path}: MMDs {mmds}")
        say("grid_small_eval", path=repr(path), weights=repr(res["weights"]),
            graphs=GRID_SMALL_EVAL_GRAPHS, test_graphs=len(adjs[te]), batch=batch, rounds=rounds,
            steps=int(cfg.sde.adj.num_scales), steps_per_s=f"{res['steps_per_s']:.2f}",
            mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}",
            mmd=json.dumps(res["mmd"]), cc_mmd=json.dumps(res["cc_mmd"]),
            eval_seconds=f"{res['eval_seconds']:.3f}", card=repr(smi_name_power()),
            launches=json.dumps(launches))
        out[f"{GRID_SMALL} eval {'default' if fused else 'unfused'}"] = launches
    return out


def phase_grid_train(dev):
    """grid (N = 361) at its published widths: the gradients of the full
    loss on GRID_GRAD_GRAPHS training graphs against a float64 CPU copy
    (phase_train_grads' bound), then ``Trainer`` for GRID_TRAIN_EPOCHS
    epochs on the dataset it generates from the seed (ten train and three
    test batches of 8 an epoch): finite losses, the last epoch's mean below
    the first's, the exact launches of an epoch (the tiled backwards: the
    gcn_degrees, gmh_projection, gmh_bwd_layout, gmh_score_grad and
    gmh_attention_bwd_tiled launches; no one-block gmh_attention_bwd; no
    gcn_degrees of gcn_aggregate_bwd's own, which reads its forward's),
    train steps/s and peak memory; returns the launches."""
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    folder = os.path.join(HERE, "build", "smoke_grid")
    shutil.rmtree(folder, ignore_errors=True)
    config = train_config(folder, "smoke", GRID_TRAIN_EPOCHS, data=GRID_CONFIG)
    published = int(get_config(GRID_CONFIG, seed=0, folder=HERE).train.num_epochs)
    N = int(config.data.max_node_num)
    adjs = generated_adjs(GRID_CONFIG, int(config.get("seed", 42)), N)
    phase_train_grads(config, adjs, dev, GRID_GRAD_GRAPHS, "grid_train_grads")

    trainer = Trainer(config, adjs=adjs)
    check(trainer.device.type == "cuda", f"the trainer runs on {trainer.device}")
    n_train, n_test = len(trainer.train_loader), len(trainer.test_loader)
    check([n_train, n_test] == [10, 3], f"{GRID_CONFIG}: {n_train} train and {n_test} test "
                                        "batches an epoch, expected 10 and 3")
    depth, L = int(config.model.depth), int(config.model.num_layers)
    steps = n_train + n_test  # forwards; the train steps also run a backward
    per_epoch = {"gcn_aggregate": steps * depth, "gmh_attention": steps * L,
                 "gmh_projection": (steps + n_train) * L,
                 "gcn_degrees": steps * (depth + L) + n_train * L,
                 "gcn_aggregate_bwd": n_train * depth, "gmh_bwd_layout": n_train * L,
                 "gmh_score_grad": n_train * L, "gmh_attention_bwd_tiled": n_train * L}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    expect = {k: GRID_TRAIN_EPOCHS * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"{GRID_CONFIG} train: launches {launches}, expected exactly "
                              f"{expect}")
    hist, test = np.asarray(trainer.history["train"]), np.asarray(trainer.history["test"])
    first, last = hist[0], hist[-1]
    say("grid_train", epochs=trainer.epoch, cut=f"{GRID_TRAIN_EPOCHS} of {published}",
        steps=trainer.step, seconds=f"{seconds:.3f}",
        loss_x=f"{first[0]:.4f}->{last[0]:.4f}", loss_adj=f"{first[1]:.4f}->{last[1]:.4f}",
        test_loss_x=f"{test[0][0]:.4f}->{test[-1][0]:.4f}",
        test_loss_adj=f"{test[0][1]:.4f}->{test[-1][1]:.4f}",
        launches_per_epoch=json.dumps({k: v // GRID_TRAIN_EPOCHS for k, v in launches.items()
                                       if v}),
        peak_memory_gib=f"{peak / 2**30:.3f}")
    say("train_steps_per_s", config=GRID_CONFIG, steps_per_s=f"{trainer.step / seconds:.2f}",
        card=repr(smi_name_power()))
    check(np.isfinite(hist).all() and np.isfinite(test).all(), "non-finite grid losses")
    check(bool((last < first).all()), f"grid losses did not fall: epoch 1 {first}, "
                                      f"epoch {trainer.epoch} {last}")
    return launches


# -------------------------------------------------------------------- CC --

def cc_inputs(config, B, seed):
    """(x, adj, rank2, flags) of B samples of the config's CC dataset: the
    lift of B of its graphs (incidence 0/1) plus Gaussian noise, as a
    diffusion state at a middle t, all masked by the graphs' flags."""
    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs, init_features, lifted_rank2
    from ccsd_tpu_torch.ops.cells import get_spec
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_rank2, mask_x

    d = config.data
    N = int(d.max_node_num)
    adjs = generated_adjs(str(d.data), seed, N)[:B]
    spec = get_spec(N, int(d.d_min), int(d.d_max))
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy((adjs.sum(-1) > 0).astype(np.float32))

    def noisy(a, scale=0.3):
        return torch.from_numpy((a + scale * rng.standard_normal(a.shape)).astype(np.float32))

    x = mask_x(noisy(init_features(d.init, adjs, int(d.max_feat_num))), flags)
    adj = mask_adjs(sym(noisy(np.triu(adjs, 1))), flags)
    rank2 = mask_rank2(noisy(lifted_rank2(adjs, d)), spec, flags)
    return x, adj, rank2, flags


def phase_cc_models(dev):
    """community_small_CC's networks (seeded weights) on the card against a
    float64 CPU copy, with exact launch counts per call; returns each
    network's launches."""
    from ccsd_tpu_torch.utils.config import get_config

    return check_cc_networks(get_config(CC_CONFIG, seed=0, folder=HERE), CC_CONFIG, CC_NET_B,
                             "cc_models", dev)


def check_cc_networks(c, config_name, B, phase, dev):
    """The three networks of the CC config ``c`` (seeded weights; the
    adjacency and F networks unfused and fused) at batch B on the card
    against a float64 CPU copy, with exact launch counts per call; returns
    each network's launches."""
    import copy

    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused

    defs = dict(zip(("x", "adj", "rank2"), load_model_params(c)))
    g = torch.Generator().manual_seed(4)
    base = {n: load_model(d, generator=g) for n, d in defs.items()}
    x, adj, rank2, flags = cc_inputs(c, B, 6)
    depth, L = int(c.model.depth), int(c.model.num_layers)
    adj_net = str(c.model.adj)
    out = {}
    for name, net, d, expect in (
            ("ScoreNetworkX", "x", defs["x"], {"gcn_aggregate": depth}),
            (f"{adj_net} unfused", "adj", defs["adj"], {"gmh_attention": L}),
            (f"{adj_net} fused", "adj", with_fused(defs)["adj"],
             {"channel_agg": L, "gmh_scores": L}),
            ("ScoreNetworkF unfused", "rank2", defs["rank2"], {}),
            ("ScoreNetworkF fused", "rank2", with_fused(defs)["rank2"], {})):
        model = load_model(d).eval()
        model.load_state_dict(base[net].state_dict())
        card = copy.deepcopy(model).to(dev)
        reset_launches()
        with torch.no_grad():
            got = card(x.to(dev), adj.to(dev), rank2=rank2.to(dev), flags=flags.to(dev))
            torch.cuda.synchronize()
            launched = {k: v for k, v in LAUNCHES.items() if v}
            cpu32 = model(x, adj, rank2=rank2, flags=flags).double()
            ref = model.double()(x.double(), adj.double(), rank2=rank2.double(),
                                 flags=flags.double())
        check(launched == expect, f"{config_name} {name}: launches {launched}, expected "
                                  f"{expect}")
        cpu_err = (cpu32 - ref).abs().max().item()
        tol = dict(MODEL_TOL, atol=max(MODEL_TOL["atol"], CC_F32_FACTOR * cpu_err))
        abs_err, rel_err, ok = compare(got.cpu().double(), ref, tol)
        say(phase, model=f"{config_name} {name}", shape="x".join(map(str, got.shape)),
            launches=json.dumps(launched), max_abs_err=f"{abs_err:.3e}",
            max_rel_err=f"{rel_err:.3e}", max_abs_ref=f"{ref.abs().max().item():.3e}",
            cpu_f32_max_abs_err=f"{cpu_err:.3e}", tol=json.dumps(tol), ok=ok)
        check(ok, f"{config_name} {name} on the card disagrees with the CPU copy")
        out[f"{config_name} {name}"] = launched
    return out


def cc_train_config(folder, name, epochs, config_name=CC_CONFIG):
    return train_config(folder, name, epochs, data=config_name)


def phase_cc_train():
    """community_small_CC through ``Trainer`` for CC_TRAIN_EPOCHS epochs, in
    two calls, and a run resumed at the half; returns (launches, checkpoint
    name)."""
    return train_cc(CC_CONFIG, CC_TRAIN_EPOCHS, "smoke_cc", "cc_train")


def train_cc(config_name, epochs, subdir, phase):
    """The CC config ``config_name`` (one train and one test batch an
    epoch) through ``Trainer`` for ``epochs`` epochs, in two calls, under
    build/``subdir``: finite, falling losses, exact launches an epoch, train
    steps/s, peak memory, and a run resumed at the half equal to the
    uninterrupted one; returns (launches, checkpoint name)."""
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    folder = os.path.join(HERE, "build", subdir)
    shutil.rmtree(folder, ignore_errors=True)
    config = cc_train_config(folder, "smoke", epochs, config_name)
    published = int(get_config(config_name, seed=0, folder=HERE).train.num_epochs)
    trainer = Trainer(config)
    check(trainer.device.type == "cuda" and trainer.names == ("x", "adj", "rank2"),
          f"the CC trainer runs {trainer.names} on {trainer.device}")
    check([len(trainer.train_loader), len(trainer.test_loader)] == [1, 1],
          f"an epoch of {config_name} is not one train and one test batch")
    depth, L = int(config.model.depth), int(config.model.num_layers)
    per_epoch = {"gcn_aggregate": 2 * depth, "gmh_attention": 2 * L,
                 "gcn_aggregate_bwd": depth, "gmh_attention_bwd": L}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.config.train.num_epochs = epochs // 2
    name = trainer.train()
    mid = trainer.checkpoint_path(f"{name}_mid")
    shutil.copyfile(trainer.checkpoint_path(f"{name}_final"), mid)
    trainer.config.train.num_epochs = epochs
    trainer.train()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {k: epochs * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"{config_name} train: launches {launches}, expected exactly "
                              f"{expect}")
    hist, test = np.asarray(trainer.history["train"]), np.asarray(trainer.history["test"])
    first, end = hist[0], hist[-10:].mean(axis=0)
    say(phase, epochs=trainer.epoch, cut=f"{epochs} of {published}",
        steps=trainer.step, seconds=f"{seconds:.3f}",
        **{f"loss_{n}": f"{first[i]:.4f}->{hist[-1][i]:.4f}"
           for i, n in enumerate(trainer.names)},
        **{f"test_loss_{n}": f"{test[0][i]:.4f}->{test[-1][i]:.4f}"
           for i, n in enumerate(trainer.names)},
        launches_per_epoch=json.dumps({k: v // epochs for k, v in launches.items()
                                       if v}),
        peak_memory_gib=f"{peak / 2**30:.3f}")
    say("train_steps_per_s", config=config_name, steps_per_s=f"{trainer.step / seconds:.2f}",
        card=repr(smi_name_power()))
    check(np.isfinite(hist).all() and np.isfinite(test).all(), "non-finite CC training losses")
    check(bool((end < first).all()), f"CC losses did not fall: epoch 1 {first}, last ten {end}")

    resumed = Trainer(cc_train_config(folder, "smoke_resumed", epochs, config_name))
    resumed.load_checkpoint(f"{name}_mid")
    resumed.train()
    for n in trainer.names:
        for (k, a), b in zip(trainer.models[n].state_dict().items(),
                             resumed.models[n].state_dict().values()):
            check(torch.equal(a, b), f"resumed {n}.{k} differs from the uninterrupted run")
        for a, b in zip(trainer.emas[n].shadow_params, resumed.emas[n].shadow_params):
            check(torch.equal(a, b), f"resumed EMA of {n} differs from the uninterrupted run")
    check(resumed.history == trainer.history, "resumed CC losses differ from the uninterrupted "
                                              "run")
    say(f"{phase}_resume", resumed_from_epoch=epochs // 2, to=resumed.epoch,
        equals_uninterrupted=True)
    return launches, f"{name}_final"


def phase_cc_sample(ckpt):
    """The cc_train checkpoint by the JAX protocol on both paths at
    ``sample.score_dtype: f32`` and at the config's default (bf16), with
    its gates; returns {path: launches}."""
    return sample_cc(CC_CONFIG, CC_TRAIN_EPOCHS, "smoke_cc", ckpt, "cc_sample")


def sample_cc(config_name, epochs, subdir, ckpt, phase):
    """The checkpoint ``ckpt`` of ``train_cc`` (under build/``subdir``) by
    the JAX protocol on both paths, at ``sample.score_dtype: f32`` and at
    the config's default score dtype (bf16 for community_small_CC's data,
    as in the JAX package): exact launches, the CC checks of
    ``check_cc_sample``, finite graph and CC MMDs, cells per CC, steps/s,
    peak memory; returns {path: launches}, the bf16 runs' names ending
    BF16_RUN."""
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import Sampler, sampling_rounds, score_dtype_default

    folder = os.path.join(HERE, "build", subdir)
    cfg = cc_train_config(folder, "smoke", epochs, config_name)
    adjs = generated_adjs(str(cfg.data.data), int(cfg.get("seed", 42)),
                          int(cfg.data.max_node_num))
    tr, te = split(len(adjs), float(cfg.data.test_split))
    batch, rounds = sampling_rounds(int(cfg.data.batch_size), len(adjs[te]),
                                    cfg.sample.get("divide_batch"))
    out = {}
    for score_dtype, fused in (("f32", True), ("f32", False), (None, True), (None, False)):
        path = "default (sample.fused on)" if fused else "sample.fused: false"
        path += f", sample.score_dtype: {score_dtype or 'default'}"
        cfg = cc_train_config(folder, "smoke", epochs, config_name)
        cfg.ckpt, cfg.sample.fused = ckpt, fused
        if score_dtype:
            cfg.sample.score_dtype = score_dtype
        ungated = score_dtype is None and (config_name, fused) in BF16_NOT_GATED
        cfg.sample.eval = not ungated  # an ungated run is scored below only if finite
        sampler = Sampler(cfg, adjs[tr], adjs[te])
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = sampler.sample()
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        expect = sample_launches(cfg, fused, rounds)
        check(launches == expect, f"{config_name} {path}: launches {launches}, expected exactly "
                                  f"{expect}")
        want = score_dtype or score_dtype_default(True, cfg.data.data)
        check((res["score_dtype"], res["dtype"]) == (want, "f32"),
              f"{config_name} {path}: resolved {res['score_dtype']}, {res['dtype']}")
        run = f"{config_name} sample {'default' if fused else 'unfused'}"
        out[run if res["score_dtype"] == "f32" else f"{run} bf16{BF16_RUN}"] = launches
        if ungated and not res["finite"]:
            say(phase, path=repr(path), score_dtype=res["score_dtype"], finite=False,
                gated=False, steps_per_s=f"{res['steps_per_s']:.2f}",
                note="left f32, as BF16_NOT_GATED records", launches=json.dumps(launches))
            continue
        if ungated:
            res.update(sampler.evaluate(adjs[te], res["adj"], res["ccs"]))
            res["eval_seconds"] = float("nan")
        check_cc_sample(res, cfg, len(adjs[te]), f"{config_name} {path}")
        mmds = {**res["mmd"], **res["cc_mmd"]}
        check(len(mmds) == 8 and all(math.isfinite(v) for v in mmds.values()),
              f"{config_name} {path}: MMDs {mmds}")
        say(phase, path=repr(path), score_dtype=res["score_dtype"], dtype=res["dtype"],
            weights=repr(res["weights"]), graphs=len(adjs[te]),
            batch=batch, rounds=rounds, steps=int(cfg.sde.adj.num_scales),
            steps_per_s=f"{res['steps_per_s']:.2f}",
            sampling_seconds=f"{res['sampling_time']:.3f}",
            mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}",
            cells_per_cc=f"{res['cells_per_cc']:.3f}", mmd=json.dumps(res["mmd"]),
            cc_mmd=json.dumps(res["cc_mmd"]), eval_seconds=f"{res['eval_seconds']:.3f}",
            peak_memory_gib=f"{peak / 2**30:.3f}", card=repr(smi_name_power()),
            launches=json.dumps(launches))
    return out


def check_cc_sample(res, cfg, graphs, path):
    """A CC sampler's result on the card: ``graphs`` finite samples of the
    config's shapes, the adjacency 0/1, symmetric, zero-diagonal, the
    rank-2 entries 0/1 and only on present edges and cells."""
    import numpy as np
    from ccsd_tpu_torch.ops.cells import get_spec

    d = cfg.data
    spec = get_spec(int(d.max_node_num), int(d.d_min), int(d.d_max))
    adj, rank2, flags = res["adj"], res["rank2"], res["flags"]
    N = int(d.max_node_num)
    check(res["device"].startswith("cuda") and res["finite"],
          f"{path}: device {res['device']}, finite {res['finite']}")
    check(adj.shape == (graphs, N, N) and rank2.shape == (graphs, spec.num_edges, spec.num_cells),
          f"{path}: adj {adj.shape}, rank2 {rank2.shape}")
    check(set(np.unique(adj)) <= {0.0, 1.0} and np.array_equal(adj, adj.transpose(0, 2, 1))
          and not adj[:, np.arange(N), np.arange(N)].any(),
          f"{path}: adjacency not 0/1, symmetric, zero-diagonal")
    live_e = flags[:, spec.edge_u] * flags[:, spec.edge_v]
    live_c = (1 - flags) @ spec.cell_mask.T < 0.5
    check(set(np.unique(rank2)) <= {0, 1} and not rank2[live_e == 0].any()
          and not rank2.transpose(0, 2, 1)[~live_c].any(),
          f"{path}: rank-2 entries on absent edges or cells")


# ---------------------------------------- Base_CC, dense grid_small CC, S4 --

def base_cc_config(config_name, **fields):
    """The CC config ``config_name`` (``get_config``, or ``train_config``
    given ``fields``), grid_small_Base_CC's F head set to
    GRID_BASE_CC_NUM_LAYERS_MLP layers."""
    from ccsd_tpu_torch.utils.config import get_config

    c = train_config(data=config_name, **fields) if fields else get_config(
        config_name, seed=0, folder=HERE)
    if config_name == GRID_BASE_CC_CONFIG:
        c.model.num_layers_mlp = GRID_BASE_CC_NUM_LAYERS_MLP
    return c


def phase_base_cc_models(dev):
    """community_small_Base_CC's networks at CC_NET_B and
    grid_small_Base_CC's at GRID_CC_NET_B (seeded weights; the adjacency
    network ScoreNetworkA_Base_CC and F unfused and fused) on the card
    against a float64 CPU copy, with exact launches per call; returns each
    network's launches."""
    out = check_cc_networks(base_cc_config(BASE_CC_CONFIG), BASE_CC_CONFIG, CC_NET_B,
                            "base_cc_models", dev)
    out.update(check_cc_networks(base_cc_config(GRID_BASE_CC_CONFIG), GRID_BASE_CC_CONFIG,
                                 GRID_CC_NET_B, "base_cc_models", dev))
    return out


def phase_grid_cc():
    """Dense grid_small_CC and grid_small_Base_CC at full width through
    ``Trainer`` (B = 8 on the lift of the 100 generated grids, held on the
    card in uint8) for GRID_CC_EPOCHS epochs, with the sampler's SDEs set
    to GRID_CC_SAMPLE_STEPS steps (the loss does not read them); then the
    checkpoint through ``Sampler.sample`` on each path, one round at the
    protocol's batch (``sample.max_samples``); returns {run: launches}."""
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.ops.cells import get_spec
    from ccsd_tpu_torch.sampling.sampler import Sampler, sampling_rounds
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    runs = {}
    for name, epochs in GRID_CC_EPOCHS.items():
        folder = os.path.join(HERE, "build", f"smoke_{name}")
        shutil.rmtree(folder, ignore_errors=True)

        def grid_cc_config():
            c = base_cc_config(name, folder=folder, name="smoke", epochs=epochs)
            for k in ("x", "adj", "rank2"):
                c.sde[k].num_scales = GRID_CC_SAMPLE_STEPS
            return c

        config = grid_cc_config()
        d = config.data
        spec = get_spec(int(d.max_node_num), int(d.d_min), int(d.d_max))
        t0 = time.perf_counter()
        trainer = Trainer(config)
        setup = time.perf_counter() - t0
        n_train, n_test = len(trainer.train_loader), len(trainer.test_loader)
        check([n_train, n_test] == [10, 3], f"{name}: {n_train} train and {n_test} test "
                                            "batches an epoch, expected 10 and 3")
        held = [a for ld in (trainer.train_loader, trainer.test_loader) for a in ld.arrays]
        check(all(a.device.type == "cuda" for a in held) and held[2].dtype == torch.uint8
              and tuple(held[2].shape[1:]) == (spec.num_edges, spec.num_cells),
              f"{name}: the dataset is not held on the card with uint8 incidences")
        depth, L = int(config.model.depth), int(config.model.num_layers)
        per_epoch = {"gcn_aggregate": (n_train + n_test) * depth,
                     "gmh_attention": (n_train + n_test) * L,
                     "gcn_aggregate_bwd": n_train * depth, "gmh_attention_bwd": n_train * L}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        ckpt = f"{trainer.train()}_final"
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        expect = {k: epochs * per_epoch.get(k, 0) for k in LAUNCHES}
        check(launches == expect, f"{name} train: launches {launches}, expected exactly "
                                  f"{expect}")
        hist, test = np.asarray(trainer.history["train"]), np.asarray(trainer.history["test"])
        check(np.isfinite(hist).all() and np.isfinite(test).all(),
              f"{name}: non-finite training losses")
        published = int(get_config(name, seed=0, folder=HERE).train.num_epochs)
        say("grid_cc", config=name, run="train", epochs=trainer.epoch,
            cut=f"{epochs} of {published}", batch=int(d.batch_size), E=spec.num_edges,
            K=spec.num_cells, steps=trainer.step, seconds=f"{seconds:.3f}",
            setup_seconds=f"{setup:.3f}",
            **{f"loss_{n}": f"{hist[0][i]:.4f}->{hist[-1][i]:.4f}"
               for i, n in enumerate(trainer.names)},
            launches_per_epoch=json.dumps({k: v // epochs for k, v in launches.items() if v}),
            peak_memory_gib=f"{peak / 2**30:.3f}")
        say("train_steps_per_s", config=name, steps_per_s=f"{trainer.step / seconds:.2f}",
            card=repr(smi_name_power()))
        runs[f"{name} train"] = launches
        del trainer, held
        torch.cuda.empty_cache()

        adjs = generated_adjs(str(d.data), int(config.get("seed", 42)), int(d.max_node_num))
        tr, te = split(len(adjs), float(d.test_split))
        batch, _ = sampling_rounds(int(d.batch_size), len(adjs[te]),
                                   config.sample.get("divide_batch"))
        for fused in (True, False):
            path = "default (sample.fused on)" if fused else "sample.fused: false"
            cfg = grid_cc_config()
            cfg.ckpt, cfg.sample.fused = ckpt, fused
            cfg.sample.max_samples, cfg.sample.eval = batch, False
            sampler = Sampler(cfg, adjs[tr], adjs[te])
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            res = sampler.sample()
            launches = dict(LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            expect = sample_launches(cfg, fused)
            say("grid_cc", config=name, run="sample", path=repr(path),
                weights=repr(res["weights"]), batch=batch,
                steps=int(cfg.sde.adj.num_scales),
                note="the protocol's 1000-step sample is the quality run's "
                     "(scripts/port_quality_run.py)",
                finite=res["finite"], steps_per_s=f"{res['steps_per_s']:.2f}",
                sampling_seconds=f"{res['sampling_time']:.3f}",
                mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}",
                cells_per_cc=f"{res['cells_per_cc']:.3f}",
                peak_memory_gib=f"{peak / 2**30:.3f}", card=repr(smi_name_power()),
                launches=json.dumps(launches))
            check(launches == expect, f"{name} {path}: launches {launches}, expected exactly "
                                      f"{expect}")
            check_cc_sample(res, cfg, batch, f"{name} {path}")
            runs[f"{name} sample {'default' if fused else 'unfused'}"] = launches
    return runs


def phase_s4_sample(ckpt, train_adjs):
    """The train phase's checkpoint ``ckpt`` (community_small) through
    ``Sampler`` with ``sampler.predictor: S4``: 128 graphs, 1000 steps, on
    both paths (the sample phase ran both at these shapes before): exact
    launches (one evaluation of each network a step), valid graphs,
    steps/s; returns {path: launches}."""
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import Sampler

    folder = os.path.join(HERE, "build", "smoke_train")
    out = {}
    for fused in (True, False):
        path = "default (sample.fused, sample.fast on)" if fused else "sample.fused: false"
        cfg = train_config(folder, "smoke", TRAIN_EPOCHS)
        cfg.ckpt, cfg.sample.fused, cfg.sampler.predictor = ckpt, fused, "S4"
        sampler = Sampler(cfg, train_adjs)
        reset_launches()
        res = sampler.sample(128)
        launches = dict(LAUNCHES)
        expect = sample_launches(cfg, fused)
        check_graphs(res, cfg, 128, f"S4 {path}")
        check(launches == expect, f"S4 {path}: launches {launches}, expected exactly {expect}")
        say("s4_sample", path=repr(path), weights=repr(res["weights"]), graphs=128,
            steps=int(cfg.sde.adj.num_scales), predictor="S4", snr=cfg.sampler.snr,
            scale_eps=cfg.sampler.scale_eps, seconds=f"{res['sampling_time']:.3f}",
            steps_per_s=f"{res['steps_per_s']:.2f}",
            mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}",
            mean_nodes=f"{res['flags'].sum(-1).mean():.3f}", card=repr(smi_name_power()),
            launches=json.dumps(launches), expected=json.dumps(expect))
        out[f"community_small S4 {'default' if fused else 'unfused'}"] = launches
    return out


# ------------------------------------ bf16 sampling, ScoreNetworkX_GMH --

def phase_bf16_models(dev):
    """community_small_CC's networks as ``sample.score_dtype: bf16`` runs
    them (the score functions' bf16 copies of seeded weights, f32 scores)
    at CC_NET_B on the card against a float64 CPU copy: ScoreNetworkX,
    ScoreNetworkA (graph mode, unfused and fused fast), ScoreNetworkA_CC and
    ScoreNetworkA_Base_CC unfused and fused, ScoreNetworkF unfused and
    fused.  The card may lie BF16_NET_FACTOR times as far from float64 as
    the CPU's bf16 copy (the plain versions) of the same score function,
    and never need be closer than phase 4's tolerance; exact launches per
    call; returns each network's launches (bf16 kernels)."""
    import copy

    import torch
    from ccsd_tpu_torch.diffusion.losses import get_score_fn, get_score_fn_cc
    from ccsd_tpu_torch.diffusion.sde import VPSDE
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused

    sde = VPSDE(N=1000, beta_min=0.1, beta_max=1.0)
    out = {}
    for config_name in (CC_CONFIG, BASE_CC_CONFIG):
        c = base_cc_config(config_name)
        defs = dict(zip(("x", "adj", "rank2"), load_model_params(c)))
        graph_a = dict(load_model_params(sample_config())[1], max_node_num=defs["adj"][
            "max_node_num"])
        g = torch.Generator().manual_seed(5)
        base = {n: load_model(d, generator=g) for n, d in dict(defs, graph_a=graph_a).items()}
        x, adj, rank2, flags = cc_inputs(c, CC_NET_B, 7)
        t = torch.full((CC_NET_B,), 0.5)
        depth, L = int(c.model.depth), int(c.model.num_layers)
        adj_net = str(c.model.adj)
        cases = [(f"{adj_net} unfused", "adj", defs["adj"], {"gmh_attention": L}),
                 (f"{adj_net} fused", "adj", with_fused(defs)["adj"],
                  {"channel_agg": L, "gmh_scores": L})]
        if config_name == CC_CONFIG:
            cases = [("ScoreNetworkX", "x", defs["x"], {"gcn_aggregate": depth}),
                     ("ScoreNetworkA unfused", "graph_a", graph_a, {"gmh_attention": L}),
                     ("ScoreNetworkA fused fast", "graph_a",
                      with_fused({"a": graph_a})["a"], {"channel_agg": L, "gmh_scores": L}),
                     *cases, ("ScoreNetworkF unfused", "rank2", defs["rank2"], {}),
                     ("ScoreNetworkF fused", "rank2", with_fused(defs)["rank2"], {})]
        for name, net, d, expect in cases:
            model = load_model(d).eval()
            model.load_state_dict(base[net].state_dict())
            ref64 = copy.deepcopy(base[net]).double()

            def score(m, bf16, *a):
                if net == "graph_a":
                    return get_score_fn(sde, m, bf16)(a[0], a[1], a[3], a[4])
                return get_score_fn_cc(sde, m, bf16)(*a)

            card = copy.deepcopy(model).to(dev)
            args = (x, adj, rank2, flags, t)
            reset_launches()
            with torch.no_grad():
                got = score(card, torch.bfloat16, *(a.to(dev) for a in args))
                torch.cuda.synchronize()
                launched = {k: v for k, v in LAUNCHES.items() if v}
                cpu16 = score(model, torch.bfloat16, *args).double()
                ref = score(ref64, None, *(a.double() for a in args))
            check(got.dtype == torch.float32, f"bf16 {name}: scores in {got.dtype}")
            check(launched == expect, f"bf16 {name}: launches {launched}, expected {expect}")
            cpu_err = (cpu16 - ref).abs().max().item()
            tol = dict(MODEL_TOL, atol=max(MODEL_TOL["atol"], BF16_NET_FACTOR * cpu_err))
            abs_err, rel_err, ok = compare(got.cpu().double(), ref, tol)
            say("bf16_models", model=f"{config_name} {name}", shape="x".join(map(str, got.shape)),
                launches=json.dumps(launched), max_abs_err=f"{abs_err:.3e}",
                max_rel_err=f"{rel_err:.3e}", max_abs_ref=f"{ref.abs().max().item():.3e}",
                cpu_bf16_max_abs_err=f"{cpu_err:.3e}", tol=json.dumps(tol), ok=ok)
            check(ok, f"bf16 {config_name} {name} on the card disagrees with the CPU copy")
            out[f"{config_name} bf16 {name}{BF16_RUN}"] = launched
    return out


def recording_sampler(cfg, *adjs):
    """A ``Sampler`` whose networks record the dtypes of their tensor
    inputs (x, the adjacency, the rank-2 tensor): {network: {dtype}}."""
    from ccsd_tpu_torch.sampling.sampler import Sampler

    seen = {}

    class Recording(Sampler):
        def load_models(self, read=None):
            configt, models, source = super().load_models(read)
            for n, m in models.items():
                def hook(mod, args, kwargs, n=n):
                    ts = list(args[:2]) + [kwargs.get("rank2")]
                    seen.setdefault(n, set()).update(str(t.dtype) for t in ts
                                                     if t is not None)
                m.register_forward_pre_hook(hook, with_kwargs=True)
            return configt, models, source

    return Recording(cfg, *adjs), seen


def phase_carry_bf16(ckpt, train_adjs, cc_ckpt):
    """``sample.dtype: bf16`` (the bf16 reverse diffusion carry) on the
    default path: community_small's train-phase checkpoint (128 graphs) and
    community_small_CC's cc_train checkpoint (the JAX protocol, at its
    default bf16 score networks), 1000 steps each: every network sees bf16
    carries, the outputs are finite and valid, exact launches (the graph
    networks cast the carry up to their f32 parameters, so community_small
    launches its f32 kernels; community_small_CC's networks run in bf16);
    prints steps/s; returns {run: launches}."""
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.sampling.sampler import sampling_rounds

    out = {}
    cfg = train_config(os.path.join(HERE, "build", "smoke_train"), "smoke", TRAIN_EPOCHS)
    cfg.ckpt, cfg.sample.dtype = ckpt, "bf16"
    sampler, seen = recording_sampler(cfg, train_adjs)
    reset_launches()
    res = sampler.sample(128)
    launches = dict(LAUNCHES)
    path = "community_small default, sample.dtype: bf16"
    check_graphs(res, cfg, 128, path)
    expect = sample_launches(cfg, True)
    check(launches == expect, f"{path}: launches {launches}, expected exactly {expect}")
    check(res["dtype"] == "bf16" and all(v == {"torch.bfloat16"} for v in seen.values())
          and len(seen) == 2, f"{path}: dtype {res['dtype']}, network inputs {seen}")
    say("carry_bf16", path=repr(path), graphs=128, steps=int(cfg.sde.adj.num_scales),
        score_dtype=res["score_dtype"], dtype=res["dtype"], inputs=json.dumps(
            {k: sorted(v) for k, v in seen.items()}), steps_per_s=f"{res['steps_per_s']:.2f}",
        mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}", card=repr(smi_name_power()),
        launches=json.dumps(launches))
    out["community_small sample.dtype bf16"] = launches

    cfg = cc_train_config(os.path.join(HERE, "build", "smoke_cc"), "smoke", CC_TRAIN_EPOCHS)
    cfg.ckpt, cfg.sample.dtype = cc_ckpt, "bf16"
    adjs = generated_adjs(str(cfg.data.data), int(cfg.get("seed", 42)),
                          int(cfg.data.max_node_num))
    tr, te = split(len(adjs), float(cfg.data.test_split))
    sampler, seen = recording_sampler(cfg, adjs[tr], adjs[te])
    reset_launches()
    res = sampler.sample()
    launches = dict(LAUNCHES)
    path = f"{CC_CONFIG} default, sample.dtype: bf16"
    _, rounds = sampling_rounds(int(cfg.data.batch_size), len(adjs[te]))
    expect = sample_launches(cfg, True, rounds)
    check(launches == expect, f"{path}: launches {launches}, expected exactly {expect}")
    check_cc_sample(res, cfg, len(adjs[te]), path)
    check((res["score_dtype"], res["dtype"]) == ("bf16", "bf16") and len(seen) == 3
          and all(v == {"torch.bfloat16"} for v in seen.values()),
          f"{path}: dtypes {res['score_dtype']}, {res['dtype']}, network inputs {seen}")
    mmds = {**res["mmd"], **res["cc_mmd"]}
    check(all(math.isfinite(v) for v in mmds.values()), f"{path}: MMDs {mmds}")
    say("carry_bf16", path=repr(path), graphs=len(adjs[te]), score_dtype=res["score_dtype"],
        dtype=res["dtype"], inputs=json.dumps({k: sorted(v) for k, v in seen.items()}),
        steps_per_s=f"{res['steps_per_s']:.2f}", cells_per_cc=f"{res['cells_per_cc']:.3f}",
        mmd=json.dumps(res["mmd"]), cc_mmd=json.dumps(res["cc_mmd"]),
        card=repr(smi_name_power()), launches=json.dumps(launches))
    out[f"{CC_CONFIG} sample.dtype bf16{BF16_RUN}"] = launches
    return out


def gmh_x_config(folder=None, name="smoke", epochs=None):
    """community_small with ``model.x: ScoreNetworkX_GMH`` (its X network
    of depth AttentionLayers at the config's widths: the JAX package's
    test of the network, tests/models/test_fused_attention.py:61-64)."""
    c = train_config(folder or os.path.join(HERE, "build", "smoke_gmh_x"), name,
                     epochs or GMH_X_EPOCHS)
    c.model.x = "ScoreNetworkX_GMH"
    return c


def phase_gmh_x(train_adjs, dev):
    """ScoreNetworkX_GMH (community_small's widths): the network unfused,
    fused and fused fast (B = 128, seeded weights) on the card against a
    float64 CPU copy, with exact launches; GMH_X_EPOCHS epochs through
    ``Trainer`` (finite losses, exact launches an epoch, train steps/s);
    then ``Sampler`` (128 graphs, 1000 steps) on both paths with exact
    launches and valid graphs, on seeded weights with the adjacency head
    scaled as phase 5's (``smoke_sampler``): the 20-epoch checkpoint, like
    seeded weights at full scale, leaves f32 within the 1000 steps (a CPU
    rehearsal at B = 8: every entry NaN, quantized to 1); returns {run:
    launches}."""
    import copy
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import init_flags
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
    from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x
    from ccsd_tpu_torch.training.trainer import Trainer

    config = gmh_x_config()
    dx = load_model_params(config)[0]
    depth, L = int(config.model.depth), int(config.model.num_layers)
    check(dx["model_type"] == "ScoreNetworkX_GMH", f"model.x gave {dx['model_type']}")
    net = load_model(dx, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    B, N, F = 128, int(config.data.max_node_num), int(config.data.max_feat_num)
    flags = torch.from_numpy(init_flags(train_adjs, B, rng))
    x = mask_x(torch.from_numpy(rng.standard_normal((B, N, F)).astype(np.float32)), flags)
    adj = mask_adjs(sym(torch.from_numpy(rng.standard_normal((B, N, N)).astype(np.float32))),
                    flags)
    with torch.no_grad():
        ref = copy.deepcopy(net).double()(x.double(), adj.double(), flags.double())
    out = {}
    for name, d, expect, tol in (
            ("unfused", dx, {"gmh_attention": depth}, MODEL_TOL),
            ("fused f32", with_fused({"x": dx}, fast=False)["x"],
             {"channel_agg": depth, "gmh_scores": depth}, MODEL_TOL),
            ("fused fast", with_fused({"x": dx})["x"],
             {"channel_agg": depth, "gmh_scores": depth}, BF16_MODEL_TOL)):
        model = load_model(d).eval()
        model.load_state_dict(net.state_dict())
        card = model.to(dev)
        reset_launches()
        with torch.no_grad():
            got = card(x.to(dev), adj.to(dev), flags.to(dev))
            torch.cuda.synchronize()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        check(launched == expect, f"ScoreNetworkX_GMH {name}: launches {launched}, expected "
                                  f"{expect}")
        abs_err, rel_err, ok = compare(got.cpu().double(), ref, tol)
        say("gmh_x", model=f"ScoreNetworkX_GMH {name}", shape="x".join(map(str, got.shape)),
            launches=json.dumps(launched), max_abs_err=f"{abs_err:.3e}",
            max_rel_err=f"{rel_err:.3e}", tol=json.dumps(tol), ok=ok)
        check(ok, f"ScoreNetworkX_GMH {name} on the card disagrees with the CPU copy")
        out[f"ScoreNetworkX_GMH {name}"] = launched

    shutil.rmtree(config.folder, ignore_errors=True)
    trainer = Trainer(config, adjs=train_adjs)
    check([len(trainer.train_loader), len(trainer.test_loader)] == [1, 1],
          "an epoch of community_small is not one train and one test batch")
    reset_launches()
    t0 = time.perf_counter()
    name = trainer.train()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    per_epoch = {"gmh_attention": 2 * (depth + L), "gmh_attention_bwd": depth + L}
    expect = {k: GMH_X_EPOCHS * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"ScoreNetworkX_GMH train: launches {launches}, expected "
                              f"exactly {expect}")
    hist = np.asarray(trainer.history["train"])
    check(np.isfinite(hist).all(), "non-finite ScoreNetworkX_GMH training losses")
    say("gmh_x", epochs=trainer.epoch, ckpt=f"{name}_final", seconds=f"{seconds:.3f}",
        **{f"loss_{n}": f"{hist[0][i]:.4f}->{hist[-1][i]:.4f}"
           for i, n in enumerate(trainer.names)},
        launches_per_epoch=json.dumps({k: v // GMH_X_EPOCHS for k, v in launches.items() if v}))
    say("train_steps_per_s", config="community_small ScoreNetworkX_GMH",
        steps_per_s=f"{trainer.step / seconds:.2f}", card=repr(smi_name_power()))
    out["community_small ScoreNetworkX_GMH train"] = launches

    for fused in (True, False):
        path = "default (sample.fused, sample.fast on)" if fused else "sample.fused: false"
        cfg = gmh_x_config()
        cfg.sample.fused = fused
        sampler = smoke_sampler(cfg, train_adjs)
        reset_launches()
        res = sampler.sample(128)
        launches = dict(LAUNCHES)
        expect = sample_launches(cfg, fused)
        check_graphs(res, cfg, 128, f"ScoreNetworkX_GMH {path}")
        check(launches == expect, f"ScoreNetworkX_GMH {path}: launches {launches}, expected "
                                  f"exactly {expect}")
        say("gmh_x", path=repr(path), weights=repr(res["weights"]), graphs=128,
            steps=int(cfg.sde.adj.num_scales), steps_per_s=f"{res['steps_per_s']:.2f}",
            mean_edges=f"{res['adj'].sum((1, 2)).mean() / 2:.3f}",
            card=repr(smi_name_power()), launches=json.dumps(launches))
        out[f"community_small ScoreNetworkX_GMH {'default' if fused else 'unfused'}"] = launches
    return out


# ------------------------------------------------------------- two-stage --

def phase_ts_models(dev):
    """The two-stage F network (seeded weights) over per-sample universes
    bridged from TS_NET_B community_small_CC graphs, through the slab form,
    on the card against a float64 CPU copy: no hand kernel launches."""
    import copy

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs
    from ccsd_tpu_torch.diffusion.two_stage import dynamic_cells_from_adjs, incidence_from_dynamic
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.registry import load_model, load_model_params
    from ccsd_tpu_torch.ops.cells import get_spec
    from ccsd_tpu_torch.ops.masks import mask_rank2_dynamic
    from ccsd_tpu_torch.utils.config import get_config

    c = get_config(TS_CONFIG, seed=0, folder=HERE)
    d = c.data
    N = int(d.max_node_num)
    spec = get_spec(N, int(d.d_min), int(d.d_max))
    adjs = generated_adjs(CC_CONFIG, 6, N)[:TS_NET_B]
    dyn = dynamic_cells_from_adjs(adjs, int(d.d_min), int(d.d_max), None,
                                  lifting_procedure=d.lifting_procedure, path_length=int(d.d_max))
    flags = torch.from_numpy((adjs.sum(-1) > 0).astype(np.float32))
    rng = np.random.default_rng(6)
    clean = incidence_from_dynamic(torch.from_numpy(adjs), spec, dyn)
    rank2 = mask_rank2_dynamic(
        clean + 0.3 * torch.from_numpy(rng.standard_normal(clean.shape).astype(np.float32)),
        spec, dyn.member, dyn.valid, flags)
    model = load_model(load_model_params(c, is_cc=True)[2],
                       generator=torch.Generator().manual_seed(4)).eval()
    card = copy.deepcopy(model).to(dev)
    ddyn = dyn.to(dev)
    reset_launches()
    with torch.no_grad():
        got = card(None, None, rank2.to(dev), flags=flags.to(dev),
                   dyn=(ddyn.member, ddyn.valid))
        torch.cuda.synchronize()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        cpu32 = model(None, None, rank2, flags=flags, dyn=(dyn.member, dyn.valid)).double()
        ref = model.double()(None, None, rank2.double(), flags=flags.double(),
                             dyn=(dyn.member.double(), dyn.valid.double()))
    check(not launched, f"{TS_CONFIG} ScoreNetworkF launched {launched}")
    cpu_err = (cpu32 - ref).abs().max().item()
    tol = dict(MODEL_TOL, atol=max(MODEL_TOL["atol"], CC_F32_FACTOR * cpu_err))
    abs_err, rel_err, ok = compare(got.cpu().double(), ref, tol)
    say("ts_models", model=f"{TS_CONFIG} ScoreNetworkF (dynamic universe)",
        shape="x".join(map(str, got.shape)), k_max=dyn.k_max,
        valid_slots=int(dyn.valid.sum()), max_abs_err=f"{abs_err:.3e}",
        max_rel_err=f"{rel_err:.3e}", max_abs_ref=f"{ref.abs().max().item():.3e}",
        cpu_f32_max_abs_err=f"{cpu_err:.3e}", tol=json.dumps(tol), ok=ok)
    check(ok, f"{TS_CONFIG} ScoreNetworkF on the card disagrees with the CPU copy")


def ts_train_config(folder, name, epochs):
    return train_config(folder, name, epochs, data=TS_CONFIG)


def phase_ts_train():
    """``TwoStageTrainer`` at full width for TS_TRAIN_EPOCHS epochs: three
    finite, falling losses and exact launches an epoch; returns (launches,
    checkpoint name)."""
    import shutil

    import numpy as np
    import torch
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.training.trainer import get_trainer_from_config
    from ccsd_tpu_torch.utils.config import get_config

    folder = os.path.join(HERE, "build", "smoke_ts")
    shutil.rmtree(folder, ignore_errors=True)
    config = ts_train_config(folder, "smoke", TS_TRAIN_EPOCHS)
    published = int(get_config(TS_CONFIG, seed=0, folder=HERE).train.num_epochs)
    trainer = get_trainer_from_config(config)
    check(type(trainer).__name__ == "TwoStageTrainer" and trainer.device.type == "cuda",
          f"{TS_CONFIG} trains with {type(trainer).__name__} on {trainer.device}")
    depth, L = int(config.model.depth), int(config.model.num_layers)
    per_epoch = {"gcn_aggregate": depth, "gmh_attention": L,
                 "gcn_aggregate_bwd": depth, "gmh_attention_bwd": L}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    name = trainer.train()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {k: TS_TRAIN_EPOCHS * per_epoch.get(k, 0) for k in LAUNCHES}
    check(launches == expect, f"{TS_CONFIG} train: launches {launches}, expected exactly "
                              f"{expect}")
    hist = np.asarray(trainer.history["train"])
    first, end = hist[0], hist[-10:].mean(axis=0)
    say("ts_train", epochs=trainer.epoch, cut=f"{TS_TRAIN_EPOCHS} of {published}",
        steps=trainer.step, train_ccs=len(trainer.train_ccs), k_max=trainer.k_max,
        seconds=f"{seconds:.3f}",
        **{f"loss_{n}": f"{first[i]:.4f}->{end[i]:.4f}" for i, n in enumerate(trainer.names)},
        launches_per_epoch=json.dumps({k: v // TS_TRAIN_EPOCHS for k, v in launches.items()
                                       if v}),
        peak_memory_gib=f"{peak / 2**30:.3f}")
    say("train_steps_per_s", config=TS_CONFIG, steps_per_s=f"{trainer.step / seconds:.2f}",
        card=repr(smi_name_power()))
    check(np.isfinite(hist).all(), "non-finite two-stage training losses")
    check(bool((end < first).all()),
          f"two-stage losses did not fall: epoch 1 {first}, last ten {end}")
    return launches, f"{name}_final"


def phase_ts_sample(ckpt):
    """The ts_train checkpoint through ``TwoStageSampler`` by the JAX
    protocol (20 test CCs: one round of 128, every CC kept; 1000 Euler +
    Langevin steps in each stage) on both graph paths: exact launches (the
    graph path's; stage 2 launches none), rank-2 entries in valid slots on
    rows of present nodes only, decoded cells on present nodes, finite
    graph and CC MMDs; prints stage 2's margin to overflow (its steps
    while finite, its largest |F|); returns {path: launches}."""
    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.ops.cells import get_spec
    from ccsd_tpu_torch.sampling.sampler import get_sampler_from_config

    folder = os.path.join(HERE, "build", "smoke_ts")
    out = {}
    for fused in (True, False):
        path = "default (sample.fused on)" if fused else "sample.fused: false"
        cfg = ts_train_config(folder, "smoke", TS_TRAIN_EPOCHS)
        cfg.ckpt, cfg.sample.fused = ckpt, fused
        d = cfg.data
        N = int(d.max_node_num)
        spec = get_spec(N, int(d.d_min), int(d.d_max))
        adjs = generated_adjs(CC_CONFIG, int(cfg.get("seed", 42)), N)
        tr, te = split(len(adjs), float(d.test_split))
        sampler = get_sampler_from_config(cfg, adjs[tr], adjs[te])
        check(type(sampler).__name__ == "TwoStageSampler",
              f"{TS_CONFIG} samples with {type(sampler).__name__}")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = sampler.sample()
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        expect = sample_launches(cfg, fused)
        check(launches == expect, f"{TS_CONFIG} {path}: launches {launches}, expected exactly "
                                  f"{expect}")
        B = int(d.batch_size)
        adj, flags = res["adj"], res["flags"]
        check(res["device"].startswith("cuda") and res["finite"],
              f"{TS_CONFIG} {path}: device {res['device']}, finite {res['finite']}")
        check(len(res["ccs"]) == B and adj.shape == (B, N, N),
              f"{TS_CONFIG} {path}: {len(res['ccs'])} CCs, adj {adj.shape}")
        check(set(np.unique(adj)) <= {0.0, 1.0} and np.array_equal(adj, adj.transpose(0, 2, 1))
              and not adj[:, np.arange(N), np.arange(N)].any(),
              f"{TS_CONFIG} {path}: adjacency not 0/1, symmetric, zero-diagonal")
        (rank2,), (valid,) = res["rank2_rounds"], res["valid_rounds"]
        live_e = flags[:, spec.edge_u] * flags[:, spec.edge_v]
        edge_in_adj = adj[:, spec.edge_u, spec.edge_v]
        nz = rank2 != 0
        check(not nz.transpose(0, 2, 1)[valid == 0].any() and not nz[live_e == 0].any(),
              f"{TS_CONFIG} {path}: rank-2 entries outside valid slots or on absent nodes")
        off_adj = int(nz[edge_in_adj == 0].sum())
        for b, cc in enumerate(res["ccs"]):
            for cell in cc.cells.hyperedge_dict.get(2, {}):
                check(all(flags[b, n] for n in cell),
                      f"{TS_CONFIG} {path}: CC {b} has cell {sorted(cell)} on an absent node")
        mmds = {**res["mmd"], **res["cc_mmd"]}
        check(len(mmds) == 8 and all(math.isfinite(v) for v in mmds.values()),
              f"{TS_CONFIG} {path}: MMDs {mmds}")
        say("ts_sample", path=repr(path), weights=repr(res["weights"]), ccs=len(res["ccs"]),
            test_ccs=len(adjs[te]), steps=int(cfg.sde.adj.num_scales), k_max=res["k_max"],
            stage1_steps_per_s=f"{res['stage1_steps_per_s']:.2f}",
            stage2_steps_per_s=f"{res['stage2_steps_per_s']:.2f}",
            stage_seconds=json.dumps({k: round(v, 3) for k, v in res["stage_seconds"].items()}),
            mean_edges=f"{adj.sum((1, 2)).mean() / 2:.3f}",
            stage2_finite_steps=res["stage2_finite_steps"],
            stage2_max_abs=f"{res['stage2_max_abs']:.6g}",
            cells_per_cc=f"{res['cells_per_cc']:.3f}", rank2_nonzeros=int(nz.sum()),
            rank2_nonzeros_off_adj=off_adj, mmd=json.dumps(res["mmd"]),
            cc_mmd=json.dumps(res["cc_mmd"]), eval_seconds=f"{res['eval_seconds']:.3f}",
            peak_memory_gib=f"{peak / 2**30:.3f}", card=repr(smi_name_power()),
            launches=json.dumps(launches))
        out[f"{TS_CONFIG} sample {'default' if fused else 'unfused'}"] = launches
    return out


def timing_specs():
    """(kernel, source, the TPU kernels it replaces, shape key, inputs,
    {variant: (kernel fn, plain fn[, a change of the inputs])} with the
    path's variant first, a maker of the PyTorch call of the same function
    or None, makers of further calls timed beside it, cost of a case).
    The cases of ``<key>_more`` are timed too and kept out of the means."""
    import functools

    import torch
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain
    from ccsd_tpu_torch.kernels.gcn import (
        gcn_aggregate,
        gcn_aggregate_bwd,
        gcn_aggregate_bwd_plain,
        gcn_aggregate_plain,
        gcn_degrees,
        gcn_degrees_plain,
        gcn_norm,
        _with_loop,
    )
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention,
        gmh_attention_bwd,
        gmh_attention_bwd_plain,
        gmh_attention_plain,
        gmh_projection,
        gmh_projection_plain,
        gmh_attention_bwd_tiled,
        gmh_attention_bwd_tiled_plain,
        gmh_bwd_layout,
        gmh_bwd_layout_plain,
        gmh_score_grad,
        gmh_score_grad_plain,
    )
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    def matmul_of_norm(adj, x):  # the product alone, norm formed before
        norm = gcn_norm(adj.contiguous())
        return lambda: torch.matmul(norm, x[:, None])

    def baddbmm_of_norm(x, adj, w, b, loop):  # norm and X W formed before
        norm, xw = gcn_norm(adj, True, loop), x @ w
        return lambda: torch.baddbmm(b, norm, xw)

    # two calls, norm, the weights and the biases formed before: norm X by
    # matmul, then (norm X) [Wq | Wk | Wv] + bias by one baddbmm over B C
    def matmul_baddbmm_of_norm(x, adj, deg, wq, bq, wk, bk, wv, bv):
        B, C, N, _ = adj.shape
        norm = (deg[..., :, None] * _with_loop(adj, 1.0) * deg[..., None, :]).contiguous()
        w = torch.cat([wq, wk, wv], -1).expand(B, -1, -1, -1).reshape(B * C, wq.shape[1], -1)
        bias = torch.cat([bq, bk, bv], -1).expand(B, -1, -1).reshape(B * C, 1, -1)

        def run():
            nx = torch.matmul(norm, x[:, None])
            return torch.baddbmm(bias, nx.view(B * C, N, -1), w)
        return run

    # the pair the fused layer ran when the kernel took norm, not adj
    def norm_then_matmul(adj, x):
        return lambda: torch.matmul(gcn_norm(adj.contiguous()), x[:, None])

    def contiguous_first(adj, x):
        return (adj.contiguous(), x)

    # dY = norm^T dL/dout by one bmm, norm formed before (as baddbmm_of_norm)
    def bmm_of_norm_t(x, adj, w, g, loop, add_loop, need_x, need_adj):
        norm = gcn_norm(adj, add_loop, loop)
        return lambda: torch.bmm(norm.mT, g)

    # the library's whole route to dx, dW and dbias: that bmm, the dX matmul
    # where dx is asked for, the dW einsum and dbias's sum
    def library_route(x, adj, w, g, loop, add_loop, need_x, need_adj):
        norm = gcn_norm(adj, add_loop, loop)

        def run():
            dy = torch.bmm(norm.mT, g)
            return (dy @ w.T if need_x else None, torch.einsum("bnf,bno->fo", x, dy),
                    g.sum(dim=(0, 1)))
        return run

    return [
        ("gcn_aggregate", "ccsd_tpu_torch/csrc/gcn_aggregate.cu",
         "ccsd_tpu/ops/pallas/gcn.py:45", "gcn", gcn_inputs,
         {"f32": (gcn_aggregate, gcn_aggregate_plain)}, baddbmm_of_norm, {},
         lambda c: gcn_cost(*c[1:5])),
        ("gmh_projection", "ccsd_tpu_torch/csrc/gmh_attention.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62 (the norm and Q, K, V stage of "
         "_gmh_kernel, :33-47, for graphs cut into row tiles)", "proj", proj_inputs,
         {"f32": (gmh_projection, gmh_projection_plain)}, matmul_baddbmm_of_norm, {},
         lambda c: proj_cost(*c[1:7])),
        ("gcn_degrees", "ccsd_tpu_torch/csrc/gcn_degrees.cu",
         "ccsd_tpu/ops/pallas/gcn.py:37 (the degree stage of _gcn_kernel, for graphs "
         "cut into row tiles)", "degrees", degrees_inputs,
         {"f32": (gcn_degrees, gcn_degrees_plain)}, None, {},
         lambda c: degrees_cost(*c[1:4])),
        ("gmh_attention", "ccsd_tpu_torch/csrc/gmh_attention.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62", "gmh", gmh_path_inputs,
         {"f32": (gmh_attention, gmh_attention_plain),
          "f32 contiguous adj": (gmh_attention, gmh_attention_plain, contiguous_adj)},
         None, {},
         lambda c: gmh_cost(*c[1:])),
        ("channel_agg", "ccsd_tpu_torch/csrc/channel_agg.cu",
         "tools/probe_pallas_agg.py:43 (agg_pallas), tools/probe_pallas_agg.py:64 "
         "(agg_pallas_2d)", "agg", agg_path_inputs,
         {"f32": (channel_agg, channel_agg_plain),
          "f32 contiguous adj": (channel_agg, channel_agg_plain, contiguous_first)},
         matmul_of_norm, {"gcn_norm_then_matmul": norm_then_matmul},
         lambda c: agg_cost(*c[1:])),
        ("gmh_scores", "ccsd_tpu_torch/csrc/gmh_scores.cu",
         "tools/pallas_scores_probe.py:85 (make_pallas_reg), "
         "tools/pallas_scores_probe.py:127 (make_pallas)", "scores", scores_inputs,
         {"bf16": (functools.partial(gmh_scores, bf16=True),
                   functools.partial(gmh_scores_plain, bf16=True)),
          "f32": (gmh_scores, gmh_scores_plain)}, None, {},
         lambda c: scores_cost(*c[1:])),
        # the bf16 variants (N <= 64): community_small_CC's shapes on the
        # path, grid_small's kept out of the means; bytes at 2 an element
        ("gcn_aggregate (bf16)", "ccsd_tpu_torch/csrc/gcn_aggregate.cu",
         "ccsd_tpu/ops/pallas/gcn.py:45", "gcn_bf16", as_bf16(gcn_inputs),
         {"bf16": (gcn_aggregate, bf16_plain(gcn_aggregate_plain))}, baddbmm_of_norm, {},
         lambda c: gcn_cost(*c[1:5], esize=2)),
        ("gmh_attention (bf16)", "ccsd_tpu_torch/csrc/gmh_attention.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62", "gmh_bf16", as_bf16(gmh_path_inputs),
         {"bf16": (gmh_attention, bf16_plain(gmh_attention_plain))}, None, {},
         lambda c: gmh_cost(*c[1:], esize=2)),
        ("channel_agg (bf16)", "ccsd_tpu_torch/csrc/channel_agg.cu",
         "tools/probe_pallas_agg.py:43 (agg_pallas), tools/probe_pallas_agg.py:64 "
         "(agg_pallas_2d)", "agg_bf16", as_bf16(agg_path_inputs),
         {"bf16": (channel_agg, bf16_plain(channel_agg_plain))}, matmul_of_norm, {},
         lambda c: agg_cost(*c[1:], esize=2)),
        ("gmh_scores (bf16)", "ccsd_tpu_torch/csrc/gmh_scores.cu",
         "tools/pallas_scores_probe.py:85 (make_pallas_reg), "
         "tools/pallas_scores_probe.py:127 (make_pallas)", "scores_bf16", scores_inputs_bf16,
         {"bf16 products": (functools.partial(gmh_scores, bf16=True),
                            bf16_plain(functools.partial(gmh_scores_plain, bf16=True))),
          "f32 products": (gmh_scores, bf16_plain(gmh_scores_plain))}, None, {},
         lambda c: scores_cost(*c[1:], esize=2)),
        ("gcn_aggregate_bwd", "ccsd_tpu_torch/csrc/gcn_aggregate_bwd.cu",
         "ccsd_tpu/ops/pallas/gcn.py:45 (the gradient of gcn_aggregate_pallas; the JAX "
         "package differentiates the plain layer)", "gcn_bwd", gcn_bwd_inputs,
         {"f32": (gcn_aggregate_bwd, gcn_aggregate_bwd_plain)}, bmm_of_norm_t,
         {"library_route": library_route},
         lambda c: gcn_bwd_cost(*c[1:5], *c[6:8])),
        ("gmh_attention_bwd", "ccsd_tpu_torch/csrc/gmh_attention_bwd.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62 (the gradient of gmh_attention_pallas; "
         "the JAX package differentiates the plain layer)", "gmh_bwd", gmh_bwd_inputs,
         {"f32": (gmh_attention_bwd, gmh_attention_bwd_plain)}, None, {},
         lambda c: gmh_bwd_cost(*c[1:])),
        ("gmh_score_grad", "ccsd_tpu_torch/csrc/gmh_attention_bwd.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62 (the gradient of the score stage of "
         "_gmh_kernel, :50-58, for graphs cut into row tiles; the JAX package "
         "differentiates the plain layer)", "score_grad", score_grad_inputs,
         {"f32": (gmh_score_grad, gmh_score_grad_plain)}, None, {},
         lambda c: score_grad_cost(c[1], c[2], c[3], c[5], c[7])),
        ("gmh_bwd_layout", "ccsd_tpu_torch/csrc/gmh_attention_bwd.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62 (the gradient of the map's "
         "symmetrisation, _gmh_kernel :58, for graphs cut into row tiles; the JAX package "
         "differentiates the plain layer)", "bwd_layout", layout_inputs,
         {"f32": (gmh_bwd_layout, gmh_bwd_layout_plain)}, None, {},
         lambda c: layout_cost(c[1], c[2], c[3], not first_layer(c))),
        ("gmh_attention_bwd_tiled", "ccsd_tpu_torch/csrc/gmh_attention_bwd.cu",
         "ccsd_tpu/ops/pallas/gmh_attention.py:62 (the gradient of the norm and Q, K, V "
         "stage of _gmh_kernel, :33-47, for graphs cut into row tiles; the JAX package "
         "differentiates the plain layer)", "bwd_rows", row_tile_inputs,
         {"f32": (gmh_attention_bwd_tiled, gmh_attention_bwd_tiled_plain)}, None, {},
         lambda c: row_tile_cost(*c[1:7], c[8], c[9])),
    ]


def tanh_rate(dev):
    """tanhf calls a second on the card: the probe of csrc/gmh_scores.cu
    (``gmh_tanh_rate_run``: eight independent chains a thread, on tanhf's
    exp branch, one FMA beside each call), eight blocks an SM, timed by
    CUDA events after a warm-up."""
    import torch
    from ccsd_tpu_torch.kernels.build import check_status, kernel_fn

    blocks, iters = 8 * torch.cuda.get_device_properties(dev).multi_processor_count, 1024
    out = torch.empty(blocks * 256, device=dev)
    fn = kernel_fn("gmh_scores", "gmh_tanh_rate_run")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        check_status("gmh_tanh_rate", fn(out.data_ptr(), blocks, iters, stream))

    run()
    ms = _events_ms(run, 1)
    calls = blocks * 256 * iters * 8
    check(bool(out.isfinite().all()), "the tanh probe gave non-finite values")
    say("timing", tanh_probe_calls=calls, ms=f"{ms:.5f}",
        tanh_per_s=f"{calls / (ms * 1e-3):.4e}", card=repr(smi_name_power()))
    return calls / (ms * 1e-3)


# the attention map kernels' tanhf calls of a case: (B, C, N, H) by key
TANH_CASE = {"gmh": lambda c: (c[1], c[2], c[3], c[7]),
             "scores": lambda c: (c[1], c[2], c[3], c[5]),
             "gmh_bf16": lambda c: (c[1], c[2], c[3], c[7]),
             "scores_bf16": lambda c: (c[1], c[2], c[3], c[5]),
             "score_grad": lambda c: (c[1], c[2], c[3], c[7])}
# the keys whose cases above N = 64 replay GRID_TIMING_ITERS times, and the
# place of N in a case of each
BIG_N = {"gmh": 3, "scores": 3, "proj": 3, "gmh_bwd": 3, "score_grad": 3, "gcn_bwd": 2,
         "bwd_layout": 3, "bwd_rows": 3}
# CUDA-graph replays of a case above N = 64 (grid): the plain versions'
# intermediates there run to ~0.5 GB a call
GRID_TIMING_ITERS = 20


def phase_timing(shapes, dev, launches, errs):
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    per_s = tanh_rate(dev)
    rows = []
    for kname, src, replaces, key, mk, variants, library, also, cost in timing_specs():
        per = []
        extra = shapes.get(f"{key}_more", [])
        with torch.no_grad():
            for case in shapes[key] + extra:
                args = mk(case, gen, dev)
                big = key in BIG_N and case[BIG_N[key]] > 64
                iters = GRID_TIMING_ITERS if big else TIMING_ITERS
                b_ms, by = bound_ms(*cost(case))
                tanh_ms = (1e3 * tanh_count(*TANH_CASE[key](case)) / per_s
                           if key in TANH_CASE else None)
                lib_ms = call_ms(library(*args), iters)[0] if library else None
                more = {f"{k}_ms": call_ms(f(*args), iters)[0] for k, f in also.items()}
                for variant, (kern, plain, *change) in variants.items():
                    a = change[0](*args) if change else args
                    ms, host_ms = call_ms(lambda: kern(*a), iters)
                    plain_ms, plain_host_ms = call_ms(lambda: plain(*a), iters)
                    per.append({"case": case[0], "variant": variant, "ms": ms,
                                "plain_ms": plain_ms, "host_loop_ms": host_ms,
                                "plain_host_loop_ms": plain_host_ms,
                                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                                "tanh_floor_ms": tanh_ms, "off_path": case in extra, **more})
                    say("timing", kernel=kname, variant=variant, case=case[0],
                        ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                        host_loop_ms=f"{host_ms:.5f}",
                        plain_host_loop_ms=f"{plain_host_ms:.5f}", bound_ms=f"{b_ms:.6f}",
                        bound_by=by, library_ms="null" if lib_ms is None else f"{lib_ms:.5f}",
                        tanh_floor_ms="null" if tanh_ms is None else f"{tanh_ms:.6f}",
                        replays=iters, **{k: f"{v:.5f}" for k, v in more.items()})
        path_variant = next(iter(variants))
        on_path = [p for p in per if p["case"] != "improved" and not p["off_path"]
                   and p["variant"] == path_variant]
        mean = lambda k: sum(p[k] for p in on_path) / len(on_path)  # noqa: E731
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": max(launches[kname].values()), "max_abs_err": errs[kname],
            # per launch, averaged over the path's layer shapes, in the
            # variant the path runs (bf16 for gmh_scores)
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": max(on_path, key=lambda p: p["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms") if library else None,
            "tanh_floor_ms": mean("tanh_floor_ms") if key in TANH_CASE else None,
            "launches_by_path": {p: n for p, n in launches[kname].items() if n},
            "shapes": per,
        })
    return rows


# device kernels by family in a profile: the port's hand kernels (by their
# __global__ names), the matmuls PyTorch hands to cuBLAS / CUTLASS, the rest
HAND_KERNELS = ("gmh_", "gcn_", "channel_agg", "tiled_scores_kernel")
GEMM_KERNELS = ("gemm", "cutlass", "cublas", "sm90_xmma", "splitK")


def profile_summary(prof, wall, path, steps):
    """Device time by kernel, by family (hand kernels, GEMMs, the rest),
    the device's busy share of the wall time and the largest host items of
    one profiled run, on one line; per step, where a row says so."""
    import torch

    events = prof.key_averages()
    # a user-annotated range (``Optimizer.step#Adam.step``) spans its kernels on
    # the device timeline: counted, it would count their time twice
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) for e in device}
    total = sum(dev_us.values())
    check(total > 0, "the profiler saw no device time")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    family = {"hand": 0.0, "gemm": 0.0, "other": 0.0}
    for k, v in dev_us.items():
        low = k.lower()
        family["hand" if any(h in k for h in HAND_KERNELS)
               else "gemm" if any(g in low for g in GEMM_KERNELS) else "other"] += v
    host = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    say("profile", path=path, steps=steps,
        wall_s=f"{wall:.4f}", device_busy_s=f"{total / 1e6:.4f}",
        busy_share=f"{total / 1e6 / wall:.4f}",
        device_ms_per_step=f"{total / 1e3 / steps:.4f}",
        wall_ms_per_step=f"{wall * 1e3 / steps:.4f}",
        device_kernels_per_step=f"{sum(e.count for e in device) / steps:.1f}",
        family_ms_per_step=json.dumps({k: round(v / 1e3 / steps, 4)
                                       for k, v in family.items()}),
        top_device_us_per_step=json.dumps([(k[:60], round(v / steps, 1)) for k, v in top]),
        top_host_self_us=json.dumps([(e.key[:40], e.count,
                                      round(e.self_cpu_time_total, 1)) for e in host]))


def _profiled(run, activities):
    """(profiler, wall seconds) of run() under torch.profiler, the card
    synchronised at the end."""
    import torch
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def phase_profile(train_adjs, out_dir):
    """torch.profiler over a 20-step sampler run of each path and 20
    training epochs of community_small (a step and a test loss each, after
    5 epochs of warm-up), then grid's (B = 8, N = 361): 20 sampler steps
    of each path (seeded weights, the adjacency head scaled as
    smoke_sampler does: 20 steps stay finite) and GRID_PROFILE_STEPS train
    steps on one batch of its generated graphs (after two of warm-up):
    device time by kernel and by family, per step, and the device's busy
    share of the wall time.  Traces: DIR/sampler_trace.json (community_small,
    default path), DIR/train_trace.json, DIR/grid_sampler_trace.json
    (default path), DIR/grid_train_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity
    from ccsd_tpu_torch.data.loader import generated_adjs
    from ccsd_tpu_torch.training.trainer import Trainer

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    os.makedirs(out_dir, exist_ok=True)
    steps = 20
    grid_adjs = generated_adjs(GRID_CONFIG, 0, 361)
    for name, adjs, graphs, prefix in (("community_small", train_adjs, 128, ""),
                                       (GRID_CONFIG, grid_adjs, 8, "grid_")):
        for fused in (True, False):
            sampler = smoke_sampler(sample_config(steps=steps, fused=fused, name=name), adjs)
            sampler.sample(graphs)  # warm-up
            prof, wall = _profiled(lambda: sampler.sample(graphs), activities)
            if fused:
                prof.export_chrome_trace(os.path.join(out_dir, f"{prefix}sampler_trace.json"))
            profile_summary(prof, wall, f"{name} " + ("default" if fused
                                                      else "sample.fused: false"), steps)

    config = train_config(os.path.join(HERE, "build", "smoke_train"), "profile", 5)
    trainer = Trainer(config, adjs=train_adjs, log=False)
    trainer.train()  # warm-up
    config.train.num_epochs = 5 + steps
    prof, wall = _profiled(trainer.train, activities)
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    profile_summary(prof, wall, "community_small train (an epoch: one step and one test loss)",
                    steps)

    config = train_config(os.path.join(HERE, "build", "smoke_grid_profile"), "profile", 1,
                          data=GRID_CONFIG)
    trainer = Trainer(config, adjs=generated_adjs(GRID_CONFIG, int(config.get("seed", 42)),
                                                  361), log=False)
    x, adj = next(iter(trainer.train_loader))
    for _ in range(2):  # warm-up
        trainer.train_step(x, adj)

    def train_steps():
        for _ in range(GRID_PROFILE_STEPS):
            trainer.train_step(x, adj)

    prof, wall = _profiled(train_steps, activities)
    prof.export_chrome_trace(os.path.join(out_dir, "grid_train_trace.json"))
    profile_summary(prof, wall, f"{GRID_CONFIG} train step (B = 8, one batch)",
                    GRID_PROFILE_STEPS)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile 20 sampler steps of each path and training, of "
                         "community_small and grid; traces into DIR")
    ap.add_argument("--profile-only", action="store_true",
                    help="with --profile: build and profile only, no other phase and no "
                         "result line")
    args = ap.parse_args(argv)
    if args.profile_only and not args.profile:
        ap.error("--profile-only needs --profile DIR")
    t0 = time.perf_counter()
    phase = "import"
    try:
        import numpy as np
        import torch

        phase = "device"
        phase_device()
        phase = "import"
        import_port()
        from ccsd_tpu_torch.data.loader import community_small_adjs, generated_adjs
        from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused

        dev = torch.device("cuda")
        phase = "build"
        t_build = time.perf_counter()
        phase_build()
        say("phase_seconds", name="build", seconds=f"{time.perf_counter() - t_build:.2f}")
        if args.profile_only:
            phase = "profile"
            t = time.perf_counter()
            phase_profile(community_small_adjs(100, 0, int(sample_config().data.max_node_num)),
                          args.profile)
            say("phase_seconds", name="profile", seconds=f"{time.perf_counter() - t:.2f}")
            return 0

        config = sample_config()
        defs = dict(zip(("x", "adj"), load_model_params(config)))
        g = torch.Generator().manual_seed(0)
        x_net, adj_net = (load_model(defs[n], generator=g).to(dev).eval() for n in defs)

        def fused(fast):  # the same weights on the fused path
            m = load_model(with_fused(defs, fast=fast)["adj"]).to(dev).eval()
            m.load_state_dict(adj_net.state_dict())
            return m

        L = int(config.model.num_layers)
        per_layer = {"channel_agg": L, "gmh_scores": L}
        models = {
            "x": (x_net, {"gcn_aggregate": int(config.model.depth)}, MODEL_TOL),
            "adj": (adj_net, {"gmh_attention": L}, MODEL_TOL),
            "adj_fused_f32": (fused(False), per_layer, MODEL_TOL),
            "adj_fused_fast": (fused(True), per_layer, BF16_MODEL_TOL),
        }
        shapes = path_shapes({"x": x_net, "adj": adj_net})
        train_adjs = community_small_adjs(100, 0, int(config.data.max_node_num))

        runs = {}  # {path's run: its launches}

        def timed(name, fn, *a):
            nonlocal phase
            phase = name
            t = time.perf_counter()
            out = fn(*a)
            say("phase_seconds", name=name, seconds=f"{time.perf_counter() - t:.2f}")
            return out

        errs = timed("kernels", phase_kernels, shapes, dev)
        timed("models", phase_models, models, train_adjs, dev)
        runs["grid ScoreNetworkX"] = timed("grid", phase_grid_x, dev)
        runs.update({f"grid ScoreNetworkA {k}": v
                     for k, v in timed("grid_a", phase_grid_a, dev).items()})
        runs.update(timed("sample", phase_sample, train_adjs, "community_small", 128,
                          "sample", None, SAMPLE_STEPS))
        # the train batch: all graphs but the first int(test_split M)
        n_train = len(train_adjs) - int(float(config.data.test_split) * len(train_adjs))
        shapes.update(train_shapes({"x": x_net, "adj": adj_net}, n_train))
        shapes.update(more_train_shapes())
        errs.update(timed("train_kernels", phase_train_kernels, shapes, dev))
        timed("train_grads", phase_train_grads, config, train_adjs, dev)
        runs["community_small train"], ckpt = timed("train", phase_train, config,
                                                    train_adjs, dev)
        timed("eval", phase_eval, config, ckpt, train_adjs)
        runs[f"{GRID_SMALL} train"], gs_ckpt = timed("grid_small_train",
                                                     phase_grid_small_train)
        runs.update(timed("grid_small_eval", phase_grid_small_eval, gs_ckpt))
        # grid's networks have grid_small's widths: grid samples from its
        # EMA weights (seeded ones overflow before step 400 at any head
        # scale tried: scripts/random_weight_divergence.py)
        grid_adjs = generated_adjs(GRID_CONFIG, 0, 361)
        runs.update(timed("grid_sample", phase_sample, grid_adjs, GRID_CONFIG, 8,
                          "grid_sample", grid_small_ckpt_path(gs_ckpt), GRID_SAMPLE_STEPS))
        runs[f"{GRID_CONFIG} train"] = timed("grid_train", phase_grid_train, dev)
        runs.update(timed("cc_models", phase_cc_models, dev))
        runs.update(timed("bf16_models", phase_bf16_models, dev))
        runs[f"{CC_CONFIG} train"], cc_ckpt = timed("cc_train", phase_cc_train)
        runs.update(timed("cc_sample", phase_cc_sample, cc_ckpt))
        runs.update(timed("carry_bf16", phase_carry_bf16, ckpt, train_adjs, cc_ckpt))
        timed("ts_models", phase_ts_models, dev)
        runs[f"{TS_CONFIG} train"], ts_ckpt = timed("ts_train", phase_ts_train)
        runs.update(timed("ts_sample", phase_ts_sample, ts_ckpt))
        runs.update(timed("base_cc_models", phase_base_cc_models, dev))
        runs[f"{BASE_CC_CONFIG} train"], base_ckpt = timed(
            "base_cc_train", train_cc, BASE_CC_CONFIG, BASE_CC_TRAIN_EPOCHS, "smoke_base_cc",
            "base_cc_train")
        runs.update(timed("base_cc_sample", sample_cc, BASE_CC_CONFIG, BASE_CC_TRAIN_EPOCHS,
                          "smoke_base_cc", base_ckpt, "base_cc_sample"))
        runs.update(timed("grid_cc", phase_grid_cc))
        runs.update(timed("s4_sample", phase_s4_sample, ckpt, train_adjs))
        runs.update(timed("gmh_x", phase_gmh_x, train_adjs, dev))
        from ccsd_tpu_torch.kernels import LAUNCHES

        # each kernel's launches by run; a bf16 variant's from the runs whose
        # networks ran in bf16, the f32 kernel's from the others
        bf16_runs = {p for p in runs if p.endswith(BF16_RUN)}
        launches = {k: {p: run.get(k, 0) for p, run in runs.items() if p not in bf16_runs}
                    for k in LAUNCHES}
        launches.update({f"{k} (bf16)": {p: runs[p].get(k, 0) for p in bf16_runs}
                         for k in BF16_KERNELS})
        idle = [k for k, by in launches.items() if not any(by.values())]
        check(not idle, f"kernels launched in no path's run: {idle}")
        rows = timed("timing", phase_timing, shapes, dev, launches, errs)
        if args.profile:
            timed("profile", phase_profile, train_adjs, args.profile)
        phase = "result"
        say("done", seconds=f"{time.perf_counter() - t0:.1f}")
        print(json.dumps({"kernels": rows}))
        print(smi_name_power())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:  # noqa: BLE001 - any failure fails the smoke
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
