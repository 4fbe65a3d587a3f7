#!/usr/bin/env python3
"""Smoke run of boxlcd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure raises and the script exits non-zero:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under boxlcd_tpu_torch/csrc/ with nvcc, in
     parallel, printing each build's seconds and, per kernel instantiation
     (the physics kernels' group sizes, the raster kernels' vertex bound
     and pose accessor), ptxas' registers, stack and spills;
  3. lcd raster vs plain: the per-frame LCD raster kernel against its plain
     torch version, bit for bit, on Urchin, LuxoCube, Object3, Bounce2 and
     CrabCube (32x32: 18 bodies, the NV = 8 instantiation) at B = 1000,
     4096 and 65536, from reset states after 3 plain-physics steps and
     from random poses that put bodies partly outside the frame; then its
     times at the VecEnv's 8 worlds, the tripwire's 16 frames (beside the
     launch floor: a one-element launch's time) and at 4000+ worlds, and
     its launch geometry (one-warp blocks) at 4000 worlds;
  4. traj raster vs plain: the trajectory raster kernel against its plain
     version, bit for bit, on the same envs, from megakernel pose streams
     and from random poses across the frame's edges, up to T x B = 64 x 4096
     = 262144 frames, and at the main path's shape (100 x 4000), where it is
     then timed, with its launch geometry;
  5. megakernel vs plain: tests/test_mega.py's six envs at B = 1024, T = 24
     (4 random-action steps, then 20 zero-action steps; that file's 34 cut
     in depth) at per-field median 0 and within that file's tail bounds,
     poses at t = 0 and 2 within 1e-4, the sleep share within 0.02; then
     the same (median within bounds) over the first 25 steps of the main
     path's shape (Urchin, 4000 worlds x 100 random-action steps), where
     the kernel is timed at 25 and 100 steps, beside its launch geometry,
     occupancy and its times at each block size launch_geometry picks from;
     then its counted instance (a traced run's) at the collection cells'
     shapes (4000 worlds at 180/60, 4096 at 8/4, 100 steps) equal to the
     uncounted one bit for bit, counted under its own launch counter, and
     over 5 steps 64 of its worlds' NGS counts equal to the plain version's;
  6. reference: the per-step core on the card against the CPU, and the
     megakernel path against the per-step path on the card from one seed
     (equal actions, t = 0 frames equal bit for bit);
  7. solver kernel vs plain: one step_world_batch with each solver hook
     (velocity, substep) against the plain step on the six envs of phase 5
     and Urchin at solver_exit_tol = 1e-4, at B = 1024 from
     tests/test_pallas.py's warm states, equal bit for bit, and the same
     states with every 2-point contact's second point dropped (equal too);
     then T = 24 rollouts with the substep kernel against phase 5's plain
     rollouts, within tests/test_mega.py's bounds;
  8. main path: `fill_barrels` for Urchin (vel_iters 8, pos_iters 4, 4000
     worlds = 4 barrels in one dispatch, 100 steps, 16x32 LCD) through the
     megakernel path, with every kernel's launch count set to 0 just before
     and read just after (megakernel 1, traj raster 1, lcd raster 1 for the
     tripwire, no solver kernel); the barrels must load and hold finite,
     non-blank data. Then the device's busy share of a whole call and the
     per-layer times of one dispatch;
  9. per-step path: `fill_barrels` with collect_mega=0 at 1000 worlds x 5
     steps (the lcd raster launches once a step), and the per-layer times of
     one step at 4000 worlds;
  10. solver path: bench.py's BENCH_SOLVER=sub line, Urchin, 4096 worlds, at
     10 of its 100 steps, of step_world_batch with the substep kernel, then
     Env.observe, launches counted as in phase 8 (substep kernel 10 x
     substeps, lcd raster 10, no other); the final state equal to the
     plain path's bit for bit; the busy share, the per-layer times of one
     step, and both solver kernels' times beside their bounds and plain
     versions, their launch geometry, occupancy and block-size times;
  11. VecEnv: Luxo in body mode, 8 envs, ep_len + 1 steps (autoreset runs;
     ep_len cut from 100 to 5), then LuxoCube in cube mode (3 steps); numpy
     observations, the lcd raster at least once a step, timeouts on ep_len;
  12. world models on Urchin (16x32, ep_len 100) at research/scripts/
     kicker.py's widths: collection through the port's research.main
     (--mode=collect, native barrels: 2 train, 1 test, one megakernel
     dispatch each, launches counted); one dispatch written as npz and as
     native, both decoding to the same arrays, with each format's write ms;
     the BVAE (hidden 64, vqK 64, vqD 16, nfilter 16, window 5, bs 64)
     trained 300 steps through the Trainer, the FBT (4 layers, 8 heads,
     n_embed 512, window 50, bs 64) 300 steps through the device-dataset
     branch (precompute_z + train_device, bfloat16 autocast) and 5 through
     the Trainer (the encode path), every logged loss finite and the last
     below the first; precompute_z's peak memory; ms a train step
     (synchronised, repeated), frames/s and peak memory; `evaluate` of each
     model (the lcd raster launches twice in each, for the proprio
     re-render); FBT.sample cached and uncached from one generator state,
     bit for bit equal, with frames/s; the card's BVAE and FBT forwards and
     losses against the same modules on the CPU (same state dict);
  13. evaluation, on phase 12's data, BVAE and FBT: the MultiStepArbiter
     (default widths, window 47 = FBT's 50 - prompt 3, so a burned sample
     is one clip) and the ArbiterAE (window 5) trained 300 steps, VAE,
     RNLDA (kicker.py's preset) and VQVAE 100 steps each, all through
     research.main's Trainer (logged losses finite, the last below the
     first; parameters, ms a step, frames/s, peak memory); UrchinCube
     collected (1 + 1 native barrels, launches counted) and the
     ObjectLocalizer trained 300 steps on it (its error on a test batch,
     its frozen file read back); the BVAE's evaluate with the ArbiterAE
     (FID, cosdist) and the FBT's with the MultiStepArbiter (FVD,
     precision/recall/F1, action log-MSEs, cosdist), each finite with 2
     lcd raster launches; --mode=eval over the FBT (5 reps, eval_n 512),
     its logger.pkl holding the JAX Evaler's keys, all finite, with its
     seconds a rep and samples/s; the arbiters' and the localizer's
     outputs and losses on the card against the CPU (phase 12's gates);
  14. video models and the learned env, on phase 12's data, BVAE and FBT
     and phase 13's RNLDA, MultiStepArbiter and ObjectLocalizer: FIT
     (kicker.py:26), RSSM (:24) and FRNLD (:30, over the RNLDA), window 50,
     prompt 3, trained 100 steps each through research.main's Trainer
     (logged losses finite, the last below the first; parameters, ms a
     step, frames/s, peak memory, device ms and events); each one's
     evaluate with the MultiStepArbiter (finite, 2 lcd raster launches);
     --mode=eval over each (5 reps of eval_n 128, logger.pkl the JAX key
     set, finite; seconds a rep, samples/s); the three on the card
     against the CPU (phase 12's gates, FRNLD's latents equal beyond 1e-4
     of a bin edge). Then the learned env: RewardLenv(LearnedEnv(128,
     FBT)), Urchin body goals, autoreset, ep_len 100, 101 random steps
     (one timeout, done on it; observations, rewards and deltas finite;
     lcd raster launches 2 a full reset + 1 a goal resample), env-steps/s,
     ms a step and the busy share of 10 profiled steps; one model step
     on the card against the CPU (codes, draws and frames equal beyond
     1e-4, probabilities and proprio within 2e-4); the FRNLD learned env
     and cube goals (UrchinCube, the frozen ObjectLocalizer over an
     untrained BVAE + FBT) 20 steps each; PreprocVecEnv over the FBT one,
     its zstate the BVAE's code;
  15. RL, on phase 12's FBT, through research.rl.main at research/scripts/
     headline_rl.sh:62-84's widths (Urchin, 128 envs, bs 4096, hidden 256,
     body goals, a test every 2nd epoch; ep_len 100 cut to 25): PPO in the
     learned env, 2 headline epochs of 375 fused dream steps (epoch s,
     learned env-steps/s, the 80 + 80 updates' ms, the busy share of 25
     more profiled steps, lcd raster launches an epoch: 2 pools, + 2 for
     the first epoch's reset), ppo.pkl reloaded to the same mean actions
     bit for bit; PPO in the real env, one fused epoch of 10 steps (cut
     from 375; ms a step, at least one lcd launch a step); eval_policy on
     the learned-env checkpoint (ITERS 10 cut to 1: 100 episodes, the
     evidence in the temp folder); SAC's replay run (cnn, 16 envs, one
     burst of update_every 40) and firehose (the learned env, mlp, 50
     iterations), ms an update, parameters moved; every run's logged values
     finite and no kernel but the lcd raster launched; one PPO pi and v
     update, one SAC update (cnn) and their forwards on the card against
     the CPU (phase 12's gates);
  16. visualisation, on phase 12's data, BVAE and FBT: research.main
     --mode=viz --optimize_actions=1 (1 rollout of the CLI's 4: 50 truth
     steps, a 10-iteration plan) and --mode=viz --interactive=1 (no pyglet
     window: the headless replay), each with one lcd raster launch a truth
     step and no other kernel, its gifs decoding to the rollout's frames
     and the truth frames equal to the plain raster's frames of the stepped
     states, bit for bit (ms a truth step, ms a plan iteration); AutoEnv
     (9 primed frames, 3 lockstep steps); render('human') into an
     ArrayViewer, its LCD half the plain frame; --mode=fiddle (s,
     vec_weights.pkl); ipython_mode (IPython.embed stood in); the media
     scripts demo_gifs, lcd_wave, viz_goal, sample_model and the examples
     basic, less_basic, collect, train at the smallest depths that exercise
     each (solver iterations 8/4), every file decoding, launches counted,
     s each; card against CPU: optimize_actions (3 iterations, the same
     uniforms) and the Fiddler's sensitivities within 2e-4, MiniGPT's
     loss after one Adam step within 1e-6 relative;
  17. entry points, on phase 12's data and FBT, with N = the card count:
     research.main --mode=collect --mesh=dpN (the per-step path, 1000
     worlds x phase 9's 5 steps, native; the lcd raster N launches a step)
     against fill_barrels' unsharded per-step path from the same seed (lcd
     and action bit for bit, floats within 3e-7); --mode=train of phase
     12's BVAE, 5 steps, --mesh=dpN against unsharded (losses within phase
     12's 1e-6 rel); research.rl.main ppo at phase 15's widths, one fused
     real-env epoch (2 steps) and one fused learned-env epoch (10 dream
     steps) with --mesh=dpN against unsharded (GAE buffers within 1e-6,
     losses within 1e-6 rel, dream frames bit for bit; over N > 1 cards a
     few dream envs may part at a token draw, `_dream_parting`, and the
     rest must still agree); --mesh=dp{N+1}
     raising JAX's assertion in all three and in dryrun_multichip;
     graft_entry.entry() and dryrun_multichip(N) at the production widths;
     the port's bench.py: the auto line at its defaults (Urchin, 4096
     worlds, 8/4, T = 100, K = 4, 3 iterations: megakernel 13 + 3 for
     mega_smoke, traj raster 13), the sub and jnp lines at BENCH_STEPS=2,
     BENCH_PIPELINE=1, 1 iteration (substep kernel 12, lcd raster 4; lcd
     raster 4), each line's env-steps/s, launches counted from 0;
  18. research tools and measurement scripts, on phase 12's data, BVAE and
     FBT, phase 14's FIT and phase 15's dream PPO checkpoint, each tool
     timed with its launches counted from 0: bench_bisect at its defaults
     (Urchin, 4096 worlds x 50 steps, 8/4; megakernel 24, traj raster 12,
     lcd raster 4: six stages of a warm-up and 3 timed calls); roofline at
     bench_bisect's +full_state rate and at phase 17's auto line;
     exit_probe at Urchin 180/60, 64 worlds, 1 step; the probes' real batch
     (fit_diag.rollout_batch: megakernel 1, traj raster 1) against its
     plain route at 64 x 5 (per-world poses within tests/test_mega.py's
     Urchin bounds, frames bit for bit where the poses agree within 1e-5);
     benchmark_e2e at its scaled default in a temp folder; model_probe (64
     x 25) over the FBT, fit_diag (B 16) over the FIT and FBT, dream_diag
     (1 epoch of 375 dream steps) over the ppo_lenv checkpoint;
     research.main --mode=train --profile=1 of the BVAE for 5 steps, its
     Chrome trace holding CUDA kernel events;
  19. the DeepSeek-V2 world model at the dream cell's shape (FBTDSV2,
     DeepSeek-V2-Lite in bfloat16, 128 envs x window 25, the benchmark's
     weight draw): two onesteps with launches counted from 0, the first
     capturing the transformer's graph (4 calls of the module: each of
     the expert kernels 4 x 26 launches), the second replaying it (none),
     the graph's logits equal the eager module's, ms a step; one MoE
     layer's routed experts on its router's routes (3,200 tokens) against
     their plain version within tests/test_torch_dsv2.py's tolerance, one
     launch each of the GEMM pass and the combine, their device ms beside
     bound_ms, the plain version's ms and the library's (three
     torch._grouped_mm), the tiling share (slots over the rows the
     kernels' tiles cover); MLA's core (eager torch) beside its bound and
     SDPA on the rotated q and k.

Prints the card line and the kernels' JSON line before the last line, which
is {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. --out writes the measurements as JSON as well.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib.util
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import _build, trace, viewer
from boxlcd_tpu_torch.data.collect import (
    fill_barrels, make_mega_rollout_fn, make_rollout_fn, pack_bits,
    write_barrel_file)
from boxlcd_tpu_torch.data.dataset import BARREL_SIZE, RolloutDataset
from boxlcd_tpu_torch.data.device_dataset import (
    DeviceDataset, make_device_trainer)
from boxlcd_tpu_torch.engine import cuda_solver, mega, physics
from boxlcd_tpu_torch.engine import spec as engine_spec
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.examples import basic as ex_basic
from boxlcd_tpu_torch.examples import collect as ex_collect
from boxlcd_tpu_torch.examples import less_basic as ex_less_basic
from boxlcd_tpu_torch.examples import model as ex_model
from boxlcd_tpu_torch.examples import train as ex_train
from boxlcd_tpu_torch.render import cuda_raster, raster, traj_raster
from boxlcd_tpu_torch.research import main as research_main
from boxlcd_tpu_torch.research import utils as research_utils
from boxlcd_tpu_torch.research.nets._base import Net, autocast, to_device
from boxlcd_tpu_torch.research.nets.autoencoders import (
    ArbiterAE, MultiStepArbiter, ObjectLocalizer)
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.runners import fiddler, vizer
from boxlcd_tpu_torch.research.runners.trainer import load_arbiter
from boxlcd_tpu_torch.research.nets.video_models._base import uniform_actions
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.rl import main as rl_main
from boxlcd_tpu_torch.research.rl.nets import gaussian_logp
from boxlcd_tpu_torch.research.rl._base import RLAlgo
from boxlcd_tpu_torch.research.rl.ppo import PPO, adam, pool_size
from boxlcd_tpu_torch.research.rl.sac import SAC
from boxlcd_tpu_torch.research.scripts import (
    bench_bisect, benchmark_e2e, dream_diag, demo_gifs, eval_policy,
    exit_probe, fit_diag, lcd_wave, model_probe, roofline, sample_model,
    viz_goal)
# one count of the megakernel's operations and the H100's peaks serve the
# roofline script and the bounds here
from boxlcd_tpu_torch.research.scripts.roofline import (
    FP32_FLOPS, HBM_BYTES_PER_S, mega_bound)
from boxlcd_tpu_torch.research.wrappers import (
    CubeGoalEnv, LearnedEnv, PreprocVecEnv, RewardLenv, VecEnv)
from boxlcd_tpu_torch.utils import AttrDict, set_tf32

ITERS = {'vel_iters': 8, 'pos_iters': 4}     # bench.py's headline setting
CHECK_ENVS = [('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
              ('Bounce2', 16, 16), ('CrabCube', 32, 32)]
CHECK_BATCHES = [1000, 4096, 65536]         # cut in depth from 262144
MAIN_ENV, MAIN_BATCH, MAIN_BARRELS = 'Urchin', 4000, 4
TRIPWIRE_FRAMES = 16                        # the main path's lcd raster call
VEC_BATCH = 8                               # the VecEnv's lcd raster call
TRAJ_SHAPES = [(2, 1000), (64, 4096)]       # (T, B), up to 262144 frames
PER_STEP_BATCH, PER_STEP_T = 1000, 5        # the per-step path, cut in depth
# tests/test_mega.py's shape is 1024 x 34 (4 random-action steps, then 30
# zero-action steps); cut to 4 + 20: of the four envs whose plain sleep
# share must pass 0.2, UrchinBall reads 0.30 and Urchin 0.39 at 24 steps on
# the CPU, Luxo and LuxoCube 0.42 and 0.53 already at 22 (0.49-0.73 at 34)
MEGA_CHECK_B, MEGA_CHECK_T = 1024, 24
MEGA_PLAIN_T = 10             # the main shape's plain steps, of its 100
# tests/test_mega.py's FIELDS and BOUNDS: (median, tail threshold, tail
# fraction, least sleep share of the plain version)
MEGA_FIELDS = ['c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'j_imp', 'j_mot',
               'j_lim', 'j_state', 'prev_motor', 'pc_imp', 'pc_id']
MEGA_BOUNDS = {
    'Urchin': (1e-4, 5e-3, 0.03, 0.2),
    'Luxo': (1e-4, 5e-3, 0.03, 0.2),
    'LuxoCube': (1e-4, 5e-3, 0.03, 0.2),
    'UrchinBall': (1e-4, 5e-3, 0.03, 0.2),
    'Bounce2': (1e-4, 5e-3, 0.03, None),
    'Object3': (1.5e-3, 5e-2, 0.2, None),
}
SOLVER_CHECK_B = 1024                       # tests/test_pallas.py's block
VEL_FIELDS = ['v', 'w', 'c', 'a']           # test_pallas: within 1e-4
SUB_FIELDS = ['v', 'w', 'c', 'a', 'wc_imp', 'pc_imp', 'j_imp', 'j_mot',
              'j_lim', 'sleep_time']        # test_pallas: within 2e-3
SOLVER_BATCH = 4096                         # bench.py's BENCH_SOLVER=sub line
SOLVER_STEPS = 10                           # its 100 steps, cut in depth
VEC_ENV, VEC_CUBE_ENV, VEC_ENVS = 'Luxo', 'LuxoCube', 8   # define_config:84
VEC_CUBE_STEPS = 3
VEC_EP_LEN = 5                              # ep_len 100, cut in depth
WM_BARRELS = {'train': 2, 'test': 1}       # the world models' data, Urchin
WM_COMMON = ['--env=Urchin', '--bs=64', '--lr=5e-4', '--vel_iters=8',
             '--pos_iters=4']               # kicker.py's --lr default
WM_BVAE = ['--hidden_size=64', '--vqK=64', '--vqD=16', '--nfilter=16',
           '--window=5']                    # research/scripts/kicker.py:20
WM_FBT = ['--n_layer=4', '--n_head=8', '--n_embed=512', '--window=50',
          '--prompt_n=3']                   # kicker.py:28, :35, :37
WM_STEPS, WM_LOG_N = 300, 100               # train steps; a log every 100
WM_TRAINER_FBT_STEPS = 5                    # FBT through the Trainer
WM_WRITES = 3                               # barrel writes a format
WM_TIMED_STEPS = 20                         # train steps a timing
WM_SAMPLE_N = 8                             # G.video_n
WM_CPU_FBT_EPISODES = 16                    # the card-vs-CPU FBT batch
# card vs CPU, float32 on both (TF32 off): logits within 2e-4 absolute,
# losses within 1e-6 relative. On the H100 float32 read 1.3e-5 to 5.3e-5
# and 0 to 8.2e-8; the same card with TF32 on read 4.8e-3 to 3.3e-2 and
# 4.3e-6 to 1.8e-5, and the smoke fails unless that control breaks the
# logit bound (PERF.md §6, the world-model chain's findings)
WM_LOGIT_TOL, WM_LOSS_RTOL = 2e-4, 1e-6
# one bfloat16-autocast forward's loss against the float32 one on the card,
# same batch: within 1e-3 relative (bfloat16 keeps 8 significant bits, a
# rounding of 3.9e-3; a mean loss averages it down: 8.0e-5 to 1.2e-4 read)
WM_BF16_LOSS_RTOL = 1e-3
# phase 13, evaluation: on phase 12's Urchin data, BVAE and FBT
EV_ARBITER = ['--window=47']    # default widths (hidden 128, nfilter 64);
# window = FBT's 50 - prompt 3, so each burned sample is one arbiter clip:
# kicker.py's --window=50 would chop 47 burned frames into no clip
EV_ARBITER_AE = ['--window=5']
EV_AES = {'VAE': ['--window=5'],
          'RNLDA': ['--hidden_size=64', '--vqK=64', '--vqD=8',
                    '--nfilter=16', '--window=5'],   # kicker.py:22
          'VQVAE': ['--window=5']}  # defaults; window 5 as the other AEs
EV_ARB_STEPS, EV_AE_STEPS = 300, 100       # kicker runs 3e4
EV_LOC_ENV, EV_LOC_STEPS = 'UrchinCube', 300   # the localizer needs an object
EV_LOC_BARRELS = {'train': 1, 'test': 1}
EV_EVAL_N, EV_REPS = 512, 5                # G.eval_n 2048, cut; the reps
EV_CPU_BATCH = 16                          # the card-vs-CPU batch, episodes
EV_FBT = ['--window=50', '--prompt_n=3']   # phase 12's FBT


def log(*args):
  print(*args, flush=True)


def card_phase():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  log(smi.splitlines()[0])
  log(f'torch {torch.__version__} cuda {torch.version.cuda} '
      f'device {torch.cuda.get_device_name(0)} '
      f'count {torch.cuda.device_count()}')
  # float32 is float32 (the world models' products and convolutions; the
  # physics has none); only the card-vs-CPU control turns TF32 on
  set_tf32(False)
  return smi.splitlines()[0]


def _template_args(mangled):
  """The template arguments of a mangled kernel instantiation's `I...E`
  list, in order: ('j', G) unsigned (the physics kernels' group size), ('b',
  0 | 1) bool (the solver kernel's position solve), ('i', NV) int (the
  raster kernels' vertex bound), ('class', name) a type (the raster kernels'
  pose accessor)."""
  args = []
  while mangled and mangled[0] != 'E':
    m = re.match(r'L([ijb])(\d+)E', mangled)
    if m:
      args.append((m.group(1), int(m.group(2))))
      mangled = mangled[m.end():]
      continue
    m = re.match(r'(\d+)', mangled)
    if not m:
      break
    n = int(m.group(1))
    args.append(('class', mangled[m.end():m.end() + n]))
    mangled = mangled[m.end() + n:]
  return args


_ARG_NAMES = {'j': 'G={}', 'b': 'position={}', 'i': 'NV={}', 'class': '{}'}


def ptxas_kernels(nvcc_log):
  """Per kernel instantiation in an `nvcc -Xptxas -v` log: {name:
  {'registers', 'stack', 'spill_stores', 'spill_loads'}}, with a template's
  arguments in the name (the physics kernels' group size G and whether the
  solver kernel runs the position solve; the raster kernels' vertex bound NV
  and pose accessor)."""
  out, name = {}, None
  for line in nvcc_log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      mangled = m.group(1)
      k = re.search(r'\d+([a-z_]+_kernel)(I)?', mangled)
      name = k.group(1) if k else mangled
      if k and k.group(2):
        args = _template_args(mangled[k.end():])
        name += '<' + ', '.join(
            _ARG_NAMES[t].format(bool(v) if t == 'b' else v)
            for t, v in args) + '>'
      out[name] = {}
    elif name is not None:
      m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                    r'(\d+) bytes spill loads', line)
      if m:
        out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
      m = re.search(r'Used (\d+) registers', line)
      if m:
        out[name]['registers'] = int(m.group(1))
  return out


def build_phase():
  t0 = time.time()
  info = _build.build_all()
  log(f'[build] {sorted(info)} in {time.time() - t0:.2f} s')
  kernels = {}
  for name, rec in sorted(info.items()):
    log(f'[build] {name}: nvcc {rec["seconds"]:.2f} s')
    for kern, r in ptxas_kernels(rec['log']).items():
      kernels[kern] = r
      log(f'[build] {name}: {kern}: {r.get("registers")} registers, '
          f'{r.get("stack")} B stack, {r.get("spill_stores")} B spill stores, '
          f'{r.get("spill_loads")} B spill loads')
  return {n: r['seconds'] for n, r in info.items()}, kernels


def _env(name, dev, **G):
  return boxlcd_tpu_torch.env_map[name](dict(ITERS, **G), device=dev)


def _stepped_poses(env, batch, gen):
  """Reset states after 3 plain-physics steps of random actions."""
  st = Env.reset(env, gen, batch)
  for _ in range(3):
    act = torch.rand((batch, env.act_size), generator=gen,
                     device=st.c.device) * 2 - 1
    st = physics.step_world_batch(env.spec, st, act)
  return st.is_circle, st.c, st.a


def _random_poses(env, batch, gen):
  """Uniform poses over 1.5x the world, so bodies cross the frame's edges."""
  s = env.spec
  dev = env.device
  st = Env.reset(env, gen, batch)
  u = torch.rand((batch, s.n, 3), generator=gen, device=dev)
  c = torch.stack([(u[..., 0] * 1.5 - 0.25) * s.width,
                   (u[..., 1] * 1.5 - 0.25) * s.height], -1)
  return st.is_circle, c, (u[..., 2] * 2 - 1) * math.pi


def wall_ms(fn, n):
  """Host-clock ms per call of fn, warm, ending in a synchronize: what a
  caller pays, the host's dispatch included."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(n):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / n


def events_ms(fn, n):
  """Device ms per call of a function of few launches: CUDA events bracket
  n calls queued behind a GPU sleep that outlasts their enqueue, so the span
  holds device work only (n * launches must stay within the launch queue)."""
  host = wall_ms(fn, n) * n / 1e3
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(int((4 * host + 0.01) * 2e9))   # cycles at <= 2 GHz
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


def profiled(fn, n):
  """(device ms, device events) per call from torch.profiler: the summed
  durations of the kernels and copies fn launches (gaps between them
  excluded), or None when the profiler sees no device time, and how many
  there were."""
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  ms, events = _device_time(prof)
  return (None if ms is None else ms / n), events / n


def _device_time(prof):
  """(device ms or None, device events) of a finished profile: the summed
  durations of its kernels and copies. Only the device's own events: a
  CPU op's self device time repeats the durations of the kernels it
  launched."""
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, 'is_user_annotation', False)]
  us = sum(e.device_time_total for e in dev)
  return (us / 1e3 if us > 0 else None), len(dev)


def profiled_ms(fn, n):
  return profiled(fn, n)[0]


def _fmt(ms):
  return 'not measured' if ms is None else f'{ms:.4f} ms'


def raster_flops(spec, is_circle, height):
  """Float operations of one frame per world for these shape flags: per
  drawn polygon the b2Mul transform (8 + 10 per vertex), one divide per edge
  and an edge crossing (mul + add) per edge and row; per drawn circle its
  bbox (8)."""
  B, N = is_circle.shape
  shape = torch.as_tensor(spec.shape_static, device=is_circle.device)
  circ = (shape == 0) | ((shape == 2) & is_circle)
  nv = torch.as_tensor(spec.nverts, device=is_circle.device).double()
  poly_ops = 8 + 10 * nv + nv + 2 * nv * height
  return float(torch.where(circ, 8.0, poly_ops.expand(B, N)).sum())


def raster_bound(spec, is_circle, width, height, consts):
  """Least time of one raster call: (bound ms, 'bytes' | 'operations').

  Bytes: each input read once (is_circle, c, cos, sin and the per-spec
  constant tables), the (B, H) int32 rows written once. Operations:
  raster_flops."""
  B, N = is_circle.shape
  nbytes = (B * N * (1 + 8 + 4 + 4) + B * height * 4
            + sum(t.numel() * t.element_size() for t in consts.values()))
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = raster_flops(spec, is_circle, height) / FP32_FLOPS * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def kernel_phase(dev):
  """The per-frame raster kernel against its plain version, bit for bit."""
  gen = torch.Generator(device=dev).manual_seed(0)
  mismatches, max_err, n_frames = 0, 0, 0
  for name, W, H in CHECK_ENVS:
    env = _env(name, dev)
    render = cuda_raster.make_batched_render(env.spec, W, H)
    for kind, poses in (('stepped', _stepped_poses), ('random', _random_poses)):
      ic, c, a = poses(env, max(CHECK_BATCHES), gen)
      for B in CHECK_BATCHES:
        icb, cb = ic[:B].contiguous(), c[:B].contiguous()
        cosa, sina = torch.cos(a[:B]), torch.sin(a[:B])
        got = render.kernel_rows(icb, cb, cosa, sina)
        want = render.plain_rows(icb, cb, cosa, sina)
        torch.cuda.synchronize()
        bad = int((got != want).any(1).sum())
        err = int((raster.unpack_rows(got, W).int()
                   - raster.unpack_rows(want, W).int()).abs().max())
        frames = raster.unpack_rows(got, W)
        if frames.all() or not frames.any():
          raise RuntimeError(f'{name} {kind} B={B}: blank frames')
        log(f'[kernel] {name} {W}x{H} {kind} B={B}: {bad} of {B} frames '
            f'differ from the plain version')
        mismatches += bad
        max_err = max(max_err, err)
        n_frames += B
  if mismatches:
    raise RuntimeError(f'lcd_raster: {mismatches} frames differ from the '
                       f'plain version')

  # times at the VecEnv's and the main path's shapes, and at 4096 and
  # max(CHECK_BATCHES) worlds
  env = _env(MAIN_ENV, dev)
  render = cuda_raster.make_batched_render(env.spec, env.lcd_w, env.lcd_h)
  times = {}
  floor = launch_floor_ms(dev)
  for B in (VEC_BATCH, TRIPWIRE_FRAMES, MAIN_BATCH, 4096, max(CHECK_BATCHES)):
    ic, c, a = _stepped_poses(env, B, gen)
    cosa, sina = torch.cos(a), torch.sin(a)
    kern = lambda: render.kernel_rows(ic, c, cosa, sina)
    plain = lambda: render.plain_rows(ic, c, cosa, sina)
    bound, by = raster_bound(env.spec, ic, env.lcd_w, env.lcd_h,
                             render.consts.tables(ic.device))
    t = times[B] = dict(
        ms=events_ms(kern, 100), prof_ms=profiled_ms(kern, 100),
        wall_ms=wall_ms(kern, 100), plain_prof_ms=profiled_ms(plain, 5),
        plain_wall_ms=wall_ms(plain, 5), bound_ms=bound, bound_by=by,
        launch_floor_ms=floor)
    # the plain version is many small launches: its device time is the sum
    # of their durations (profiler), or its wall time where that is unseen
    t['plain_ms'] = t['plain_prof_ms'] or t['plain_wall_ms']
    log(f'[kernel] {MAIN_ENV} B={B}: kernel {t["ms"]:.4f} ms device (events),'
        f' {_fmt(t["prof_ms"])} (profiler), {t["wall_ms"]:.4f} ms a call with '
        f'dispatch; launch floor {floor:.4f} ms (a one-element launch, '
        f'events); plain {_fmt(t["plain_prof_ms"])} device (profiler), '
        f'{t["plain_wall_ms"]:.3f} ms a call; bound {bound:.6f} ms ({by})')
  geometry = raster_geometry('kernel', env.spec, MAIN_BATCH, env.lcd_h,
                             times[MAIN_BATCH]['ms'])
  return dict(mismatches=mismatches, max_abs_err=max_err, frames=n_frames,
              times=times, geometry=geometry)


def launch_floor_ms(dev):
  """Device ms of a trivial one-element launch (CUDA events, 100 calls):
  the card's floor under a kernel's time at a tiny batch."""
  one = torch.zeros(1, device=dev)
  return events_ms(lambda: one.add_(1), 100)


def raster_geometry(tag, spec, frames, height, ms):
  """A raster kernel's launch geometry at `frames` frames, logged beside
  the device ms a call measured there."""
  g = cuda_raster.launch_geometry(spec, frames, height)
  log(f'[{tag}] geometry at {frames} frames: {g.lanes} lanes a frame '
      f'(NV={g.nv}), {g.frames} frames a block, {g.blocks} blocks of '
      f'{g.threads} threads, {g.shared} B dynamic shared a block; '
      f'{ms:.4f} ms device (events)')
  return dict(g._asdict(), threads=g.threads, ms=ms)


def traj_bound(spec, is_circle, T, height, consts):
  """Least time of one trajectory-raster call: (bound ms, 'bytes' |
  'operations'). Bytes: x, y, cos and sin of T frames (the stream's angle
  row is not read: cos and sin stand for it), is_circle once per world and
  the spec tables read once, the (T, B, H) int32 rows written once.
  Operations: raster_bound's per-frame count, T times."""
  B, N = is_circle.shape
  nbytes = (T * B * N * (8 + 8) + B * N + T * B * height * 4
            + sum(t.numel() * t.element_size() for t in consts.values()))
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = T * raster_flops(spec, is_circle, height) / FP32_FLOPS * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def once_ms(fn):
  """Host-clock ms of one call, ending in a synchronize (for calls long
  enough that one sample is the measurement)."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3


def _motor_speeds(env, acts):
  """(B, T, act) actions -> (T, B, J) contiguous motor speeds."""
  return physics.motor_speeds(env.spec, acts).transpose(0, 1).contiguous()


def traj_phase(dev):
  """The trajectory raster against its plain version, bit for bit."""
  gen = torch.Generator(device=dev).manual_seed(1)
  mismatches, n_frames = 0, 0
  for name, W, H in CHECK_ENVS:
    env = _env(name, dev)
    s = env.spec
    render = traj_raster.make_traj_render(s, W, H)
    for T, B in TRAJ_SHAPES:
      st = Env.reset(env, gen, B)
      acts = torch.rand((B, T, env.act_size), generator=gen, device=dev) * 2 - 1
      _, traj = mega.make_rollout(s, T).kernel_rollout(
          st, _motor_speeds(env, acts))
      u = torch.rand((T, s.n, 3, B), generator=gen, device=dev)
      rnd = torch.stack([(u[:, :, 0] * 1.5 - 0.25) * s.width,
                         (u[:, :, 1] * 1.5 - 0.25) * s.height,
                         (u[:, :, 2] * 2 - 1) * math.pi], 2)
      for kind, poses in (('megakernel', traj['stream']), ('random', rnd)):
        cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
        got = render.kernel_rows(poses, cosa, sina, st.is_circle)
        want = render.plain_rows(poses, cosa, sina, st.is_circle)
        torch.cuda.synchronize()
        bad = int((got != want).any(-1).sum())
        frames = raster.unpack_rows(got, W)
        if frames.all() or not frames.any():
          raise RuntimeError(f'{name} {kind} T={T} B={B}: blank frames')
        log(f'[traj] {name} {W}x{H} {kind} T={T} B={B}: {bad} of {T * B} '
            f'frames differ from the plain version')
        mismatches += bad
        n_frames += T * B
  if mismatches:
    raise RuntimeError(f'traj_raster: {mismatches} frames differ from the '
                       f'plain version')

  # times at the main path's shape: 100 frames of 4000 worlds
  env = _env(MAIN_ENV, dev)
  T = int(env.G.ep_len)
  render = traj_raster.make_traj_render(env.spec, env.lcd_w, env.lcd_h)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  _, traj = mega.make_rollout(env.spec, T).kernel_rollout(
      st, _motor_speeds(env, acts))
  poses = traj['stream']
  cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
  kern = lambda: render.kernel_rows(poses, cosa, sina, st.is_circle)
  plain = lambda: render.plain_rows(poses, cosa, sina, st.is_circle)
  # the timed shape is checked too, bit for bit
  got, want = kern(), plain()
  torch.cuda.synchronize()
  bad = int((got != want).any(-1).sum())
  log(f'[traj] {MAIN_ENV} {env.lcd_w}x{env.lcd_h} megakernel T={T} '
      f'B={MAIN_BATCH}: {bad} of {T * MAIN_BATCH} frames differ from the '
      f'plain version')
  mismatches += bad
  n_frames += T * MAIN_BATCH
  if mismatches:
    raise RuntimeError(f'traj_raster: {bad} frames differ from the plain '
                       f'version at the main path\'s shape')
  bound, by = traj_bound(env.spec, st.is_circle, T, env.lcd_h,
                         render.consts.tables(dev))
  t = dict(ms=events_ms(kern, 20), prof_ms=profiled_ms(kern, 20),
           plain_prof_ms=profiled_ms(plain, 1), plain_wall_ms=wall_ms(plain, 1),
           bound_ms=bound, bound_by=by)
  t['plain_ms'] = t['plain_prof_ms'] or t['plain_wall_ms']
  log(f'[traj] {MAIN_ENV} T={T} B={MAIN_BATCH}: kernel {t["ms"]:.4f} ms '
      f'device (events), {_fmt(t["prof_ms"])} (profiler); plain '
      f'{_fmt(t["plain_prof_ms"])} device (profiler), '
      f'{t["plain_wall_ms"]:.2f} ms a call; bound {bound:.6f} ms ({by})')
  geometry = raster_geometry('traj', env.spec, T * MAIN_BATCH, env.lcd_h,
                             t['ms'])
  return dict(mismatches=mismatches, max_abs_err=0 if not mismatches else 1,
              frames=n_frames, times=t, geometry=geometry)


def _per_world_check(label, B, bounds, new, ref, worst, failures,
                     exact_median=False):
  """Hold every field of tests/test_mega.py's FIELDS to its per-world median
  and tail bounds of ref (with exact_median, the median must be 0); adds
  each field's worst world to `worst` and each breach to `failures`.
  Returns the per-field 'median/tail' strings."""
  med_b, tail_at, tail_frac = bounds
  msg = []
  for f in MEGA_FIELDS:
    err = (getattr(ref, f).float() - getattr(new, f).float()).abs()
    err = err.reshape(B, -1).max(1).values
    med, tail = float(err.median()), float((err > tail_at).float().mean())
    worst[f] = max(worst.get(f, 0.0), float(err.max()))
    msg.append(f'{f} {med:.1e}/{tail:.3f}')
    if med >= med_b or tail >= tail_frac or (exact_median and med != 0):
      failures.append(f'{label} {f}: median {med:.2e}, tail {tail:.3f}')
  if not torch.isfinite(new.c).all():
    failures.append(f'{label}: non-finite poses')
  return msg


def _mega_check(label, B, bounds, new, traj, ref, ref_traj, worst,
                failures, sleep_min=None, tag='mega', exact_median=False):
  """Hold one rollout to tests/test_mega.py's bounds of its plain version:
  per-world median (0 with exact_median) and tail error of every field,
  poses at t = 0 and 2 within 1e-4, sleep share within 0.02 (and the plain
  version's above sleep_min where given). Adds each field's worst world to
  `worst` and each breach to `failures`."""
  msg = _per_world_check(label, B, bounds, new, ref, worst, failures,
                         exact_median)
  pose_err = max(float((traj[k][t] - ref_traj[k][t]).abs().max())
                 for k in ('c', 'a') for t in (0, 2))
  if pose_err >= 1e-4:
    failures.append(f'{label}: poses at t=0/2 differ by {pose_err:.2e}')
  f_ref = float((ref.sleep_time > 0).float().mean())
  f_new = float((new.sleep_time > 0).float().mean())
  if abs(f_ref - f_new) >= 0.02 or (sleep_min is not None
                                    and f_ref <= sleep_min):
    failures.append(f'{label}: sleep share {f_new:.3f} vs {f_ref:.3f}')
  log(f'[{tag}] {label}: median/tail per field: {", ".join(msg)}; poses '
      f't=0/2 max err {pose_err:.2e}; sleep share {f_new:.3f} (plain '
      f'{f_ref:.3f})')


def mega_phase(dev):
  """The megakernel against its plain version on tests/test_mega.py's six
  envs and bounds, then at the main path's shape (Urchin, 4000 worlds x 100
  steps of fresh random actions): the plain call over its first
  MEGA_PLAIN_T steps is timed and held to the same bounds. The least sleep
  share is not asked of it: it shows that the zero-action steps let worlds
  fall asleep, and the main path has none. Returns the measurements and,
  per env, the MEGA_CHECK_T inputs and plain rollout, which the solver
  phase holds its kernel rollouts to."""
  failures, worst, refs = [], {}, {}
  for name, (*bounds, sleep_min) in MEGA_BOUNDS.items():
    env = _env(name, dev)
    B, T = MEGA_CHECK_B, MEGA_CHECK_T   # 4 random-action steps, then zeros
    gen = torch.Generator(device=dev).manual_seed(2)
    st = Env.reset(env, gen, B)
    acts = torch.cat([torch.rand((B, 4, env.act_size), generator=gen,
                                 device=dev) * 2 - 1,
                      torch.zeros((B, T - 4, env.act_size), device=dev)], 1)
    rollout = mega.make_rollout(env.spec, T)
    ms = _motor_speeds(env, acts)
    new, traj = rollout.kernel_rollout(st, ms)
    ref, ref_traj = rollout.plain_rollout(st, ms)
    torch.cuda.synchronize()
    _mega_check(f'{name} B={B} T={T}', B, bounds, new, traj, ref, ref_traj,
                worst, failures, sleep_min, exact_median=True)
    refs[name] = (st, ms, ref, ref_traj)

  # the main path's shape: Urchin, 4000 worlds x 100 steps, the kernel
  # timed there; the plain version, ~43,000 launches a step at any width,
  # is held and timed over the first MEGA_PLAIN_T steps, as the kernel and
  # the bound are for the kernels line
  env = _env(MAIN_ENV, dev)
  T, Tp = int(env.G.ep_len), MEGA_PLAIN_T
  gen = torch.Generator(device=dev).manual_seed(3)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  ms = _motor_speeds(env, acts)
  rollout = mega.make_rollout(env.spec, T)
  short, ms_short = mega.make_rollout(env.spec, Tp), ms[:Tp].contiguous()
  final, traj = short.kernel_rollout(st, ms_short)
  # the plain version is ~10^6 small launches: one call, timed on the host
  # clock (a profiler trace of it would not fit the run), and kept
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ref, ref_traj = short.plain_rollout(st, ms_short)
  torch.cuda.synchronize()
  plain_wall = (time.perf_counter() - t0) * 1e3
  _mega_check(f'{MAIN_ENV} B={MAIN_BATCH} T={Tp}', MAIN_BATCH,
              MEGA_BOUNDS[MAIN_ENV][:3], final, traj, ref, ref_traj, worst,
              failures)
  stream_err = float((traj['stream'] - ref_traj['stream']).abs().max())
  log(f'[mega] {MAIN_ENV} B={MAIN_BATCH} T={Tp}: pose stream max err over '
      f'all steps {stream_err:.2e}')
  if failures:
    raise RuntimeError('megakernel outside the test_mega bounds:\n'
                       + '\n'.join(failures))
  bound, by, flops = mega_bound(env.spec, final, MAIN_BATCH, Tp)
  full_final, _ = rollout.kernel_rollout(st, ms)
  bound_main, _, flops_main = mega_bound(env.spec, full_final, MAIN_BATCH, T)
  t = dict(ms=events_ms(lambda: short.kernel_rollout(st, ms_short), 3),
           plain_wall_ms=plain_wall, plain_ms=plain_wall, bound_ms=bound,
           bound_by=by, flops=flops, stream_err=stream_err, steps=Tp,
           main_ms=events_ms(lambda: rollout.kernel_rollout(st, ms), 3),
           main_steps=T, main_bound_ms=bound_main, main_flops=flops_main)
  log(f'[mega] {MAIN_ENV} B={MAIN_BATCH} T={Tp}: kernel {t["ms"]:.3f} ms '
      f'device (events); plain {plain_wall:.1f} ms a call (host clock); '
      f'bound {bound:.6f} ms ({by}, {flops:.3e} flops); at the main path\'s '
      f'T={T}: kernel {t["main_ms"]:.3f} ms device (events), bound '
      f'{bound_main:.6f} ms ({flops_main:.3e} flops)')
  geometry = block_sizes(
      'mega', MAIN_BATCH,
      lambda B, th: mega.launch_geometry(env.spec, B, th), rollout.occupancy,
      lambda th: (rollout.kernel_rollout(st, ms, threads=th)[1]['stream'],),
      3)
  geometry['iterations'] = iteration_breakdown(
      'mega', env.spec, MAIN_BATCH,
      lambda sp: mega.make_rollout(sp, T).kernel_rollout(st, ms), 3)
  for name in ('CrabCube',):          # the largest group: 32 lanes a world
    spec = _env(name, dev).spec
    g = mega.launch_geometry(spec, MEGA_CHECK_B)
    occ = mega.make_rollout(spec, 2).occupancy(MEGA_CHECK_B)
    log(f'[mega] geometry {name} B={MEGA_CHECK_B}: {_geo(g, occ)}')
  counted = {label: counted_check(dev, *shape)
             for label, shape in COUNTED_SHAPES.items()}
  return dict(max_abs_err=max(worst.values()), worst=worst, times=t,
              geometry=geometry, counted=counted), refs


# the shapes of the benchmark's collection cells, where a traced run
# launches the megakernel's counted instance: Urchin, worlds, vel_iters,
# pos_iters, 100 steps
COUNTED_SHAPES = {'collect': (4000, 180, 60), 'rollout': (4096, 8, 4)}
COUNTED_SAMPLE, COUNTED_T = 64, 5


def counted_check(dev, B, vel_iters, pos_iters):
  """The megakernel's counted instance against the uncounted one at a
  collection cell's shape: the states and the pose stream of 100 steps
  equal bit for bit, each launch counted under mega_rollout.launches and
  only the counted one under mega_rollout.counted_launches, every world's
  substeps counted; then over the first COUNTED_T steps at the full width,
  each of COUNTED_SAMPLE worlds spread over the batch ran as many NGS
  iterations as the plain version of that world."""
  env = _env(MAIN_ENV, dev, vel_iters=vel_iters, pos_iters=pos_iters)
  spec, T = env.spec, int(env.G.ep_len)
  label = f'{MAIN_ENV} {vel_iters}/{pos_iters} B={B} T={T}'
  gen = torch.Generator(device=dev).manual_seed(4)
  st = Env.reset(env, gen, B)
  ms = _motor_speeds(env, torch.rand((B, T, env.act_size), generator=gen,
                                     device=dev) * 2 - 1)
  rollout = mega.make_rollout(spec, T)
  names = ('mega_rollout.launches', 'mega_rollout.counted_launches')
  c0 = [trace.counter(k) for k in names]
  new, traj = rollout.kernel_rollout(st, ms)
  c1 = [trace.counter(k) for k in names]
  counts = torch.zeros((B, 2), dtype=torch.int64, device=dev)
  cnew, ctraj = rollout.kernel_rollout(st, ms, counts=counts)
  c2 = [trace.counter(k) for k in names]
  torch.cuda.synchronize()
  diff = [f for f in physics.WorldState._fields
          if not torch.equal(getattr(new, f), getattr(cnew, f))]
  if not torch.equal(traj['stream'], ctraj['stream']):
    diff.append('stream')
  grew = ([b - a for a, b in zip(c0, c1)], [b - a for a, b in zip(c1, c2)])
  subs = counts[:, 1].unique().tolist()
  per = float(counts[:, 0].sum()) / float(counts[:, 1].sum())

  short = mega.make_rollout(spec, COUNTED_T)
  ms_t = ms[:COUNTED_T].contiguous()
  kern = torch.zeros((B, 2), dtype=torch.int64, device=dev)
  short.kernel_rollout(st, ms_t, counts=kern)
  idx = torch.linspace(0, B - 1, COUNTED_SAMPLE, device=dev).long()
  plain = torch.zeros((COUNTED_SAMPLE, 2), dtype=torch.int64, device=dev)
  short.plain_rollout(physics.WorldState(*(f[idx] for f in st)),
                      ms_t[:, idx].contiguous(), counts=plain)
  torch.cuda.synchronize()
  off = int((kern[idx] != plain).any(1).sum())
  log(f'[mega] counted instance, {label}: fields unequal to the uncounted '
      f'launch {diff or "none"}; launches counted (all, counted) '
      f'{grew[0]} uncounted, {grew[1]} counted; substeps a world {subs}; '
      f'{per:.4f} NGS iterations a world-substep; over {COUNTED_T} steps '
      f'{COUNTED_SAMPLE} sampled worlds, {off} whose NGS count differs from '
      f'the plain version')
  if diff or grew != ([1, 0], [1, 1]) or subs != [T * spec.substeps] \
      or off:
    raise RuntimeError(f'megakernel counted instance, {label}: fields '
                       f'{diff}, launches {grew}, substeps {subs}, {off} '
                       f'worlds off the plain NGS count')
  return dict(ngs_iters=per, equal=True, sample_equal=COUNTED_SAMPLE)


def _geo(g, occ):
  return (f'G={g.group} lanes a world, {g.worlds} worlds a block, '
          f'{g.blocks} blocks of {g.threads} threads, {g.shared} B dynamic '
          f'shared a block; {occ} blocks per SM resident '
          f'({occ * g.threads // 32} warps; cudaOccupancyMaxActiveBlocks'
          f'PerMultiprocessor)')


def block_sizes(tag, B, geometry, occupancy, launch, n):
  """A physics kernel at launch_geometry's chosen block size and at each
  size it picks from: the geometry, the resident blocks per SM and the
  device ms a call (events, n calls); each output equal to the chosen
  size's, bit for bit (the block size moves no world's arithmetic)."""
  ref = launch(None)
  out = {}
  for th in (None, *mega.BLOCK_THREADS):
    g = geometry(B, th)
    occ = occupancy(B, th)
    got = launch(th)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    if not same:
      raise RuntimeError(f'{tag}: {th} threads a block change the output')
    ms = events_ms(lambda: launch(th), n)
    key = 'chosen' if th is None else f'{th} threads'
    out[key] = dict(group=g.group, worlds=g.worlds, blocks=g.blocks,
                    threads=g.threads, shared=g.shared, blocks_per_sm=occ,
                    ms=ms)
    log(f'[{tag}] geometry at B={B}, {key}: {_geo(g, occ)}; {ms:.4f} ms '
        f'device (events)')
  return out


def iteration_breakdown(tag, spec, B, launch, n):
  """Where a physics kernel's time goes: its device ms a call (events, n
  calls) with the spec's velocity and position iterations, and with either
  or both set to 0 on the same inputs. With both 0 the megakernel runs
  integration, narrowphase, init, warm start and sleeping only, and the
  solver kernels only load their inputs and store their outputs."""
  out = {}
  for vi, pi in ((spec.vel_iters, spec.pos_iters), (spec.vel_iters, 0),
                 (0, spec.pos_iters), (0, 0)):
    cut = dataclasses.replace(spec, vel_iters=vi, pos_iters=pi)
    out[f'{vi}/{pi}'] = ms = events_ms(lambda: launch(cut), n)
    log(f'[{tag}] B={B} at vel_iters/pos_iters {vi}/{pi}: {ms:.4f} ms '
        f'device (events)')
  return out


def reference_phase(dev):
  """(a) The per-step rollout core on the card vs on the CPU from the same
  states and actions: full_state within tests/test_mega.py's Urchin bounds
  (median per-world error 1e-4, < 3% of worlds above 5e-3), >= 99.9% equal
  pixels. (b) The megakernel path vs the per-step path on the card from
  one generator seed: equal actions, t=0 frames equal bit for bit,
  full_state within the same bounds."""
  B, T = 64, 8
  env_cpu = _env(MAIN_ENV, 'cpu', ep_len=T)
  env_gpu = _env(MAIN_ENV, dev, ep_len=T)
  st = Env.reset(env_cpu, torch.Generator().manual_seed(1), B)
  acts = torch.rand((B, T, env_cpu.act_size),
                    generator=torch.Generator().manual_seed(2)) * 2 - 1
  want = make_rollout_fn(env_cpu)[0].core(st, acts)
  st_gpu = physics.state_from_numpy(physics.state_to_numpy(st), dev)
  got = make_rollout_fn(env_gpu)[0].core(st_gpu, acts.to(dev))
  fs, fs_ref = got['full_state'].cpu().numpy(), want['full_state'].numpy()
  if fs.shape != (B, T, env_cpu.obs_size) or not np.isfinite(fs).all():
    raise RuntimeError(f'full_state {fs.shape} is not finite or misshapen')
  err = np.abs(fs - fs_ref).reshape(B, -1).max(1)
  same = float((got['lcd'].cpu() == want['lcd']).float().mean())
  log(f'[reference] card vs CPU core, {MAIN_ENV} B={B} T={T}: full_state '
      f'median err {np.median(err):.2e}, worlds > 5e-3: '
      f'{(err > 5e-3).mean():.3f}, equal pixels {same:.5f}')
  if np.median(err) >= 1e-4 or (err > 5e-3).mean() >= 0.03 or same < 0.999:
    raise RuntimeError('the card disagrees with the CPU reference')

  step = make_rollout_fn(env_gpu)[0](torch.Generator(device=dev).manual_seed(5), B)
  meg = make_mega_rollout_fn(env_gpu)[0](
      torch.Generator(device=dev).manual_seed(5), B)
  ok = bool(meg.pop('obs_ok'))
  err_m = (step['full_state'] - meg['full_state']).abs().reshape(B, -1)
  err_m = err_m.max(1).values.cpu().numpy()
  t0_same = bool(torch.equal(step['lcd'][:, 0], meg['lcd'][:, 0]))
  act_same = bool(torch.equal(step['action'], meg['action']))
  pix = float((step['lcd'] == meg['lcd']).float().mean())
  log(f'[reference] mega path vs per-step path on the card, {MAIN_ENV} B={B}'
      f' T={T}: tripwire {ok}, actions equal {act_same}, t=0 frames equal '
      f'{t0_same}, full_state median err {np.median(err_m):.2e}, worlds > '
      f'5e-3: {(err_m > 5e-3).mean():.3f}, equal pixels {pix:.5f}')
  if not (ok and act_same and t0_same) or np.median(err_m) >= 1e-4 \
      or (err_m > 5e-3).mean() >= 0.03:
    raise RuntimeError('the megakernel path disagrees with the per-step path')
  return dict(median_err=float(np.median(err)), equal_pixels=same,
              mega_median_err=float(np.median(err_m)), mega_equal_pixels=pix)


# each kernel's launch counter in the tracer, by the name the smoke prints
LAUNCH_COUNTERS = {'mega_rollout': 'mega_rollout.launches',
                   'traj_raster': 'traj_raster.launches',
                   'lcd_raster': 'lcd_raster.launches',
                   'velocity_solver': 'solver.velocity.launches',
                   'substep_solver': 'solver.substep.launches',
                   'moe_gate_up': 'moe_gate_up.launches',
                   'moe_down': 'moe_down.launches',
                   'moe_combine': 'moe_combine.launches'}
_LAUNCH_BASE = {}


def _zero_launches():
  """Count launches from here: _launches() reads the counters' growth."""
  torch.cuda.synchronize()
  _LAUNCH_BASE.update(trace.counters())


def _launches():
  return {k: trace.counter(c) - _LAUNCH_BASE.get(c, 0)
          for k, c in LAUNCH_COUNTERS.items()}


def _expect(**counts):
  """Every kernel's launch count: 0 unless given."""
  return dict({k: 0 for k in _launches()}, **counts)


def _check_barrels(env, folder, n_barrels, T):
  files = sorted(Path(folder).glob('*.barrel.npz'))
  if len(files) != n_barrels:
    raise RuntimeError(f'{len(files)} barrels written, not {n_barrels}')
  shape = (BARREL_SIZE, T, env.lcd_h, env.lcd_w)
  for f in files:
    with np.load(f) as z:
      lcd, fs, act = z['lcd'], z['full_state'], z['action']
    if lcd.dtype != bool or lcd.shape != shape:
      raise RuntimeError(f'{f.name}: lcd {lcd.dtype} {lcd.shape}')
    if lcd.all() or not lcd.any():
      raise RuntimeError(f'{f.name}: blank frames')
    if fs.shape != (BARREL_SIZE, T, env.obs_size) or not np.isfinite(fs).all():
      raise RuntimeError(f'{f.name}: full_state {fs.shape} not finite')
    if act.shape != (BARREL_SIZE, T, env.act_size) or np.abs(act).max() > 1:
      raise RuntimeError(f'{f.name}: action {act.shape}')
  ds = RolloutDataset(Path(folder), infinite=False)
  n_batches = sum(1 for _ in ds.batches(BARREL_SIZE))
  if n_batches != n_barrels:
    raise RuntimeError(f'RolloutDataset gave {n_batches} batches')
  log(f'[main] {len(files)} barrels load: lcd bool {shape}, background '
      f'share {float(lcd.mean()):.3f}')


def main_path_phase(dev, smi):
  """fill_barrels through the megakernel path, its launches, its barrels,
  the device's busy share, and the per-layer times of one dispatch."""
  env = _env(MAIN_ENV, dev)
  T = int(env.G.ep_len)
  gen = torch.Generator(device=dev).manual_seed(0)
  with tempfile.TemporaryDirectory() as tmp:
    G = AttrDict(logdir=Path(tmp))
    _zero_launches()
    t0 = time.perf_counter()
    fill_barrels(env, MAIN_BARRELS, 'train', G, gen, batch_size=MAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    log(f'[main] fill_barrels {MAIN_ENV} {MAIN_BATCH} worlds x {T} steps '
        f'(megakernel path): {wall:.2f} s with barrel writes, '
        f'{MAIN_BATCH * T / wall:.1f} env-steps/s on {smi}; launches '
        f'{launches}')
    if launches != _expect(mega_rollout=1, traj_raster=1, lcd_raster=1):
      raise RuntimeError(f'main path launches {launches}: each kernel must '
                         f'launch once in one dispatch')
    _check_barrels(env, Path(tmp) / 'train', MAIN_BARRELS, T)

  # the device's busy share of a whole call: summed kernel durations over
  # the call's wall time, from a second call under the profiler
  with tempfile.TemporaryDirectory() as tmp:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
      t0 = time.perf_counter()
      fill_barrels(env, MAIN_BARRELS, 'train', AttrDict(logdir=Path(tmp)),
                   gen, batch_size=MAIN_BATCH)
      torch.cuda.synchronize()
      prof_wall = time.perf_counter() - t0
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False))
  busy = dev_us / 1e6 / prof_wall
  log(f'[main] busy share of a fill_barrels call: {busy:.4f} (device '
      f'{dev_us / 1e3:.1f} ms of {prof_wall * 1e3:.1f} ms, profiled)')

  # per-layer times of one dispatch (4000 worlds x 100 steps)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  ms = _motor_speeds(env, acts)
  rollout = mega.make_rollout(env.spec, T)
  render = traj_raster.make_traj_render(env.spec, env.lcd_w, env.lcd_h)
  _, traj = rollout.kernel_rollout(st, ms)
  W = env.lcd_w
  pose0 = torch.cat([st.c.permute(1, 2, 0), st.a.T[:, None]], 1)[None]

  def concat():
    poses = torch.cat([pose0, traj['stream']])[:T]
    return poses, torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])

  poses, cosa, sina = concat()
  rows = render.kernel_rows(poses, cosa, sina, st.is_circle)
  ic, cs, as_ = mega.flat_poses(poses, st.is_circle)
  fn, _ = make_mega_rollout_fn(env, pack_lcd=True)
  out = fn.core(st, acts)

  def to_host():
    return {k: v.cpu().numpy() for k, v in out.items()}

  host = to_host()
  layers = {
      'megakernel': ('device', events_ms(
          lambda: rollout.kernel_rollout(st, ms), 3)),
      'cos_sin_concat': ('host', wall_ms(concat, 5)),
      'traj_raster': ('device', events_ms(
          lambda: render.kernel_rows(poses, cosa, sina, st.is_circle), 20)),
      'observe_pose': ('host', wall_ms(
          lambda: env.observe_pose(ic, cs, as_, lcd=False), 5)),
      'packing': ('host', wall_ms(lambda: pack_bits(raster.unpack_rows(
          rows, W).transpose(0, 1)), 5)),
      'device_to_host': ('host', wall_ms(to_host, 3)),
  }
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    for j in range(MAIN_BARRELS):
      sl = slice(j * BARREL_SIZE, (j + 1) * BARREL_SIZE)
      write_barrel_file(tmp, j, T, W, {k: v[sl] for k, v in host.items()
                                       if k != 'obs_ok'})
    layers['barrel_writes'] = ('host', (time.perf_counter() - t0) * 1e3)
  layers['dispatch'] = ('host', wall_ms(lambda: fn.core(st, acts), 2))
  for name, (clock, t) in layers.items():
    log(f'[main] layer {name}: {t:.3f} ms a dispatch ({clock} clock, '
        f'{MAIN_BATCH} worlds x {T} steps, {smi})')
  return dict(launches=launches, wall_s=wall,
              env_steps_per_s=MAIN_BATCH * T / wall, busy_share=busy,
              layers={k: t for k, (_, t) in layers.items()})


def per_step_phase(dev, smi):
  """fill_barrels with collect_mega=0 (the per-step path) at a cut depth:
  the per-frame raster launches once a step; then the per-layer times of one
  step at the main path's 4000 worlds."""
  T = PER_STEP_T
  env = _env(MAIN_ENV, dev, ep_len=T)
  gen = torch.Generator(device=dev).manual_seed(0)
  with tempfile.TemporaryDirectory() as tmp:
    _zero_launches()
    t0 = time.perf_counter()
    fill_barrels(env, 1, 'train', AttrDict(logdir=Path(tmp), collect_mega=0),
                 gen, batch_size=PER_STEP_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    log(f'[per-step] fill_barrels {MAIN_ENV} {PER_STEP_BATCH} worlds x {T} '
        f'steps, collect_mega=0: {wall:.2f} s with barrel writes, '
        f'{PER_STEP_BATCH * T / wall:.1f} env-steps/s on {smi}; launches '
        f'{launches}')
    if launches != _expect(lcd_raster=T):
      raise RuntimeError(f'per-step path launches {launches}')
    _check_barrels(env, Path(tmp) / 'train', 1, T)

  # per-layer times of one step at 4000 worlds: wall time (host clock,
  # dispatch included) and device time (profiler)
  env = _env(MAIN_ENV, dev)
  st = Env.reset(env, gen, MAIN_BATCH)
  act = torch.rand((MAIN_BATCH, env.act_size), generator=gen, device=dev)
  frame = raster.lcd_render(env.spec, st.is_circle, st.c, st.a, env.lcd_w,
                            env.lcd_h)
  # the plain physics step (~43,000 launches) timed and profiled over one
  # step, the others over 20
  layers = {
      'physics': (1, lambda: physics.step_world_batch(env.spec, st, act)),
      'raster': (20, lambda: raster.lcd_render(
          env.spec, st.is_circle, st.c, st.a, env.lcd_w, env.lcd_h)),
      'obs_packing': (20, lambda: (
          env.observe_pose(st.is_circle, st.c, st.a, lcd=False),
          pack_bits(frame))),
  }
  per_layer = {}
  for name, (n, fn) in layers.items():
    w, d = wall_ms(fn, n), profiled_ms(fn, n)
    per_layer[name] = dict(wall_ms=w, device_ms=d)
    log(f'[per-step] layer {name}: {w:.3f} ms a step with dispatch, device '
        f'{_fmt(d)} ({MAIN_BATCH} worlds, {smi})')
  return dict(launches=launches, wall_s=wall,
              env_steps_per_s=PER_STEP_BATCH * T / wall, layers=per_layer)


def _warm_states(env, B, gen):
  """tests/test_pallas.py's warm states: resets, then 3 plain steps of one
  random action, so contacts and joint limits are in play."""
  st = Env.reset(env, gen, B)
  act = torch.rand((B, env.act_size), generator=gen, device=st.c.device) * 2 - 1
  for _ in range(3):
    st = physics.step_world_batch(env.spec, st, act)
  return st, act


def _max_errs(ref, new, fields):
  return {f: float((getattr(ref, f).float() - getattr(new, f).float())
                   .abs().max()) for f in fields}


def drop_second_points(b):
  """The bundle that physics._presolve builds when Box2D drops the second
  velocity point of every 2-point contact (both points touch, the 2x2 K is
  ill-conditioned): no block solve, zero masses and impulse on point 2,
  while the position solve still sees both points touch. The zoo's states
  seldom hold such a wall contact, so the check makes them."""
  out = {}
  for pre, imp in (('w', 'wc'), ('p', 'pc')):
    both = (getattr(b, f'{pre}_nmass') > 0).all(-1)
    for f in (f'{pre}_nmass', f'{pre}_tmass', imp):
      x = getattr(b, f).clone()
      x[..., 1] = torch.where(both if f != imp else both[..., None], 0.0,
                              x[..., 1])
      out[f] = x
    out[f'{pre}_block'] = getattr(b, f'{pre}_block') & ~both
  return b._replace(**out)


def solver_phase(dev, mega_refs):
  """The solver kernel against its plain version for both hooks: one
  step_world_batch with each hook against the plain step on
  tests/test_mega.py's six envs (and Urchin at solver_exit_tol = 1e-4) at
  B = 1024 from test_pallas's warm states, equal bit for bit (velocity hook
  on v, w, c, a; substep hook on its ten fields), and the substep kernel
  against the plain solves on the same states with every 2-point contact's
  second velocity point dropped (equal too); then a
  T = MEGA_CHECK_T rollout (4 random-action steps, then zero actions) with
  the substep kernel against the mega phase's plain rollout of the same
  states and motor speeds, within test_mega's bounds."""
  failures, worst = [], {'velocity': 0.0, 'substep': 0.0}
  B = SOLVER_CHECK_B
  cases = [(name, {}) for name in MEGA_BOUNDS] + [
      (MAIN_ENV, {'solver_exit_tol': 1e-4})]
  for name, G in cases:
    env = _env(name, dev, **G)
    spec = env.spec
    st, act = _warm_states(env, B, torch.Generator(device=dev).manual_seed(4))
    ref = physics.step_world_batch(spec, st, act)
    vel = physics.step_world_batch(
        spec, st, act,
        velocity_solver=cuda_solver.make_batched_solver(spec).kernel_solve)
    sub = physics.step_world_batch(
        spec, st, act,
        substep_solver=cuda_solver.make_substep_solver(spec).kernel_solve)
    torch.cuda.synchronize()
    ev, es = _max_errs(ref, vel, VEL_FIELDS), _max_errs(ref, sub, SUB_FIELDS)
    label = f'{name}{" solver_exit_tol=1e-4" if G else ""} B={B}'
    contacts = float(((ref.wc_id >= 0).sum() + (ref.pc_id >= 0).sum()) / B)
    log(f'[solver] {label} one step, {contacts:.2f} contact points a world: '
        f'velocity hook max err '
        f'{", ".join(f"{f} {e:.2e}" for f, e in ev.items())}; substep hook '
        f'max err {", ".join(f"{f} {e:.2e}" for f, e in es.items())}')
    # the same states with every 2-point contact's second point dropped
    K = physics.consts(spec, dev)
    b, aux = physics._presolve(spec, K, st, physics.motor_speeds(spec, act))
    n_w, n_p = (int((x > 0).all(-1).sum()) for x in (b.w_nmass, b.p_nmass))
    # second points Box2D itself dropped in these states
    nat_w, nat_p = (int((m.touch.all(-1) & ~blk).sum()) for m, blk in (
        (aux.wallm, b.w_block), (aux.pairm, b.p_block)))
    b = drop_second_points(b)
    sol = cuda_solver.make_substep_solver(spec)
    got, want = sol.kernel_solve(st, b, aux), sol.plain_solve(st, b, aux)
    torch.cuda.synchronize()
    ed = max(float((g - w).abs().max()) for g, w in
             zip((got[0].v, got[0].w, got[0].wc, got[0].pc, *got[1:]),
                 (want[0].v, want[0].w, want[0].wc, want[0].pc, *want[1:])))
    log(f'[solver] {label} with the second points of {n_w} wall and {n_p} '
        f'pair contacts dropped ({nat_w} wall and {nat_p} pair dropped by '
        f'Box2D\'s rule in these states): substep kernel vs plain solves max '
        f'err {ed:.2e} (v, w, wc, pc, c, a)')
    es['dropped_points'] = ed
    # the kernels keep the plain op order in every world: equal bit for bit
    # (tests/test_pallas.py's bounds, 1e-4 and 2e-3, are far looser)
    if max(ev.values()) != 0:
      failures.append(f'{label}: velocity hook {ev}')
    if max(es.values()) != 0:
      failures.append(f'{label}: substep hook {es}')
    worst['velocity'] = max(worst['velocity'], *ev.values())
    worst['substep'] = max(worst['substep'], *es.values())

  rollout_worst = {}
  for name, (st, ms, ref, ref_traj) in mega_refs.items():
    *bounds, sleep_min = MEGA_BOUNDS[name]
    spec = _env(name, dev).spec
    solver = cuda_solver.make_substep_solver(spec).kernel_solve
    new, cs, as_ = st, [], []
    for t in range(ms.shape[0]):
      new = physics.step_world_motor(spec, new, ms[t], substep_solver=solver)
      cs.append(new.c)
      as_.append(new.a)
    torch.cuda.synchronize()
    _mega_check(f'{name} B={st.c.shape[0]} T={ms.shape[0]} substep kernel',
                st.c.shape[0], bounds, new,
                {'c': torch.stack(cs), 'a': torch.stack(as_)}, ref, ref_traj,
                rollout_worst, failures, sleep_min, tag='solver')
  if failures:
    raise RuntimeError('solver kernel outside the test_pallas / test_mega '
                       'bounds:\n' + '\n'.join(failures))
  return dict(max_abs_err=worst, rollout_worst=rollout_worst)


def solver_flops(spec, bundle, with_position):
  """Float operations of one solver launch, counted from
  csrc/physics_stages.cuh's velocity_sweep and position_solve (the velocity
  and NGS terms of mega_flops_per_substep): per world, C (45 vi + 35 pi) +
  jn (87 vi + 55 pi), plus 6 n for the position integration, with C the
  contact points that have a velocity point in this bundle (this run's
  data) and pi = 1 (the fewest iterations Box2D's exit allows); without
  the position solve, C 45 vi + jn 87 vi."""
  B = bundle.v.shape[0]
  C = float(((bundle.w_nmass > 0).sum() + (bundle.p_nmass > 0).sum()) / B)
  vi, pi = spec.vel_iters, (1 if with_position else 0)
  per_world = C * (45 * vi + 35 * pi) + spec.jn * (87 * vi + 55 * pi)
  if with_position:
    per_world += 6 * spec.n
  return per_world * B


def solver_bound(spec, tensors, bundle, with_position):
  """Least time of one solver launch: (bound ms, 'bytes' | 'operations',
  flops). Bytes: each input (the bundle, and the position solve's inputs)
  read once and each output written once; operations: solver_flops."""
  nbytes = sum(t.numel() * t.element_size() for t in tensors)
  flops = solver_flops(spec, bundle, with_position)
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / FP32_FLOPS * 1e3
  by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
  return (*by, flops)


def solver_path_phase(dev, smi):
  """bench.py's BENCH_SOLVER=sub line at full width: Urchin, 8/4 iterations,
  4096 worlds, SOLVER_STEPS steps (its 100 cut in depth) of step_world_batch
  with the substep kernel, each followed by Env.observe, whose three parts
  are summed and consumed. Every launch count is set to 0 just before and
  read just after; the final state must equal a plain rollout's from the
  same states and actions
  bit for bit. Then the busy share of 5 profiled steps, the
  per-layer times of one step with the kernel and with the plain solves,
  and both kernels' times beside their bounds."""
  env = _env(MAIN_ENV, dev)
  spec = env.spec
  T, B = SOLVER_STEPS, SOLVER_BATCH
  gen = torch.Generator(device=dev).manual_seed(6)
  st0 = Env.reset(env, gen, B)
  acts = torch.rand((T, B, env.act_size), generator=gen, device=dev) * 2 - 1
  solver = cuda_solver.make_substep_solver(spec)

  def run_path(st, n, hook=True):
    total = torch.zeros((), device=dev)
    for t in range(n):
      st = physics.step_world_batch(spec, st, acts[t],
                                    substep_solver=solver if hook else None)
      obs = Env.observe(env, st)
      total = (total + obs['full_state'].sum() + obs['proprio'].sum()
               + obs['lcd'].sum())
    return st, total

  run_path(st0, 1)                  # warm the allocator and the build
  _zero_launches()
  t0 = time.perf_counter()
  final, total = run_path(st0, T)
  total = float(total)
  wall = time.perf_counter() - t0
  launches = _launches()
  log(f'[solver-path] {MAIN_ENV} {B} worlds x {T} steps with the substep '
      f'kernel + observe: {wall:.2f} s, {B * T / wall:.1f} env-steps/s on '
      f'{smi}; launches {launches}; obs sum {total:.6e}')
  if launches != _expect(substep_solver=T * spec.substeps, lcd_raster=T):
    raise RuntimeError(f'solver path launches {launches}')
  if not math.isfinite(total):
    raise RuntimeError('solver path: non-finite observations')

  # the final state against the plain path from the same states and actions
  t0 = time.perf_counter()
  ref, _ = run_path(st0, T, hook=False)
  torch.cuda.synchronize()
  plain_wall = time.perf_counter() - t0
  failures, worst = [], {}
  msg = _per_world_check(f'{MAIN_ENV} B={B} T={T}', B,
                         MEGA_BOUNDS[MAIN_ENV][:3], final, ref, worst,
                         failures)
  unequal = [f for f in physics.WorldState._fields
             if not torch.equal(getattr(final, f), getattr(ref, f))]
  log(f'[solver-path] final state vs the plain path ({plain_wall:.2f} s): '
      f'median/tail per field: {", ".join(msg)}; worst world '
      f'{max(worst.values()):.2e}; fields not bit-equal: {unequal}')
  if failures or unequal:
    raise RuntimeError('solver path differs from the plain path:\n'
                       + '\n'.join(failures + unequal))

  # busy share of 5 steps under the profiler
  acts_p = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=acts_p) as prof:
    t0 = time.perf_counter()
    run_path(final, 5)
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
  dev_us = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False))
  busy = dev_us / 1e6 / prof_wall
  log(f'[solver-path] busy share of 5 steps: {busy:.4f} (device '
      f'{dev_us / 1e3:.1f} ms of {prof_wall * 1e3:.1f} ms, profiled)')

  # per-layer times of one step at 4096 worlds (one substep's stages; a
  # step runs `substeps` of them, then observe)
  K = physics.consts(spec, dev)
  st = final
  ms = physics.motor_speeds(spec, acts[0])
  mc = (ms != st.prev_motor) & K.j_valid
  bundle, aux = physics._presolve(spec, K, st, ms)
  b2, c, a = solver.kernel_solve(st, bundle, aux)
  vel = cuda_solver.make_batched_solver(spec)
  timed = {
      'presolve': (5, lambda: physics._presolve(spec, K, st, ms)),
      'plain_solves': (1, lambda: solver.plain_solve(st, bundle, aux)),
      'plain_velocity_solve': (1, lambda: vel.plain_solve(bundle)),
      'finalize': (5, lambda: physics._finalize(spec, K, st, b2, aux, mc, c,
                                                a)),
      'observe': (20, lambda: Env.observe(env, st)),
      'step_with_kernel': (3, lambda: run_path(st, 1)),
      'step_plain': (1, lambda: run_path(st, 1, hook=False)),
  }
  layers = {}
  for name, (n, fn) in timed.items():
    d, events = profiled(fn, n)
    layers[name] = dict(wall_ms=wall_ms(fn, n), device_ms=d,
                        device_events=events)
  layers['substep_kernel'] = dict(
      device_ms=events_ms(lambda: solver.kernel_solve(st, bundle, aux), 20),
      wall_ms=wall_ms(lambda: solver.kernel_solve(st, bundle, aux), 20))
  layers['velocity_kernel'] = dict(
      device_ms=events_ms(lambda: vel.kernel_solve(bundle), 20),
      wall_ms=wall_ms(lambda: vel.kernel_solve(bundle), 20))
  for name, t in layers.items():
    events = (f', {t["device_events"]:.0f} device events a call'
              if 'device_events' in t else '')
    log(f'[solver-path] layer {name}: {t["wall_ms"]:.3f} ms with dispatch, '
        f'device {_fmt(t["device_ms"])}{events} ({B} worlds, {smi})')

  geometry = {
      'substep': block_sizes(
          'solver-path substep', B,
          lambda B, th: mega.launch_geometry(spec, B, th),
          solver.occupancy,
          lambda th: (lambda o: (*o[0][:7], o[1], o[2]))(
              solver.kernel_solve(st, bundle, aux, threads=th)), 20),
      'velocity': block_sizes(
          'solver-path velocity', B,
          lambda B, th: mega.launch_geometry(spec, B, th),
          vel.occupancy,
          lambda th: tuple(vel.kernel_solve(bundle, threads=th)[:7]), 20)}
  geometry['substep']['iterations'] = iteration_breakdown(
      'solver-path substep', spec, B,
      lambda sp: cuda_solver.make_substep_solver(sp).kernel_solve(st, bundle,
                                                                  aux), 20)

  # both kernels beside their bounds and plain versions
  pos = [st.c, st.a, st.j_ref, aux.lc, aux.wallm.lps, aux.wallm.rad_sub,
         aux.wallm.touch, aux.pairm.lps, aux.pairm.ln, aux.pairm.lpp,
         aux.pairm.rad_sub, aux.pairm.mtype, aux.pairm.touch]
  carry = [b2.v, b2.w, b2.j_imp, b2.j_mot, b2.j_lim, b2.wc, b2.pc]
  kernels = {}
  for kind, with_pos, plain in (('substep', True, 'plain_solves'),
                                ('velocity', False, 'plain_velocity_solve')):
    tensors = list(bundle) + carry + (pos + [c, a] if with_pos else [])
    bound, by, flops = solver_bound(spec, tensors, bundle, with_pos)
    k = layers[f'{kind}_kernel']
    p = layers[plain]
    kernels[kind] = dict(ms=k['device_ms'], plain_ms=p['device_ms']
                         or p['wall_ms'], plain_wall_ms=p['wall_ms'],
                         bound_ms=bound, bound_by=by, flops=flops)
    log(f'[solver-path] {kind} kernel {k["device_ms"]:.4f} ms device '
        f'(events); plain {_fmt(p["device_ms"])} device (profiler), '
        f'{p["wall_ms"]:.2f} ms a call; bound {bound:.6f} ms ({by}, '
        f'{flops:.3e} flops, {B} worlds)')
  return dict(launches=launches, wall_s=wall, env_steps_per_s=B * T / wall,
              plain_wall_s=plain_wall, busy_share=busy, layers=layers,
              kernels=kernels, worst=worst, geometry=geometry)


def vec_env_phase(dev, smi):
  """The per-step batched env on the card: VecEnv on Luxo in body mode with
  8 envs for ep_len + 1 steps of random actions (autoreset runs; ep_len cut
  to VEC_EP_LEN), then cube
  mode on LuxoCube for a few steps. Observations come back as numpy; the
  lcd raster launches at least once a step and no other kernel runs;
  timeouts fall on ep_len."""
  G = AttrDict(goal_thresh=0.05, rew_scale=1.0)
  out = {}
  rng = np.random.default_rng(0)
  for name, mode in ((VEC_ENV, 'body'), (VEC_CUBE_ENV, 'cube')):
    env = _env(name, dev, ep_len=VEC_EP_LEN)
    ep_len = int(env.G.ep_len)
    steps = ep_len + 1 if mode == 'body' else VEC_CUBE_STEPS
    venv = VecEnv(env, VEC_ENVS, G, goal_mode=mode, seed=0)
    venv.reset()
    _zero_launches()
    t0 = time.perf_counter()
    timeouts, successes = [], []
    for t in range(steps):
      act = rng.uniform(-1, 1, (VEC_ENVS, env.act_size)).astype(np.float32)
      obs, rew, done, infos = venv.step(act)
      timeouts.append([i['timeout'] for i in infos])
      successes.append([i['success'] for i in infos])
      for k, v in obs.items():
        if not isinstance(v, np.ndarray) or v.shape[0] != VEC_ENVS:
          raise RuntimeError(f'VecEnv {mode} obs {k}: {type(v)}')
        if v.dtype != bool and not np.isfinite(v).all():
          raise RuntimeError(f'VecEnv {mode} obs {k} is not finite')
      if not (isinstance(rew, np.ndarray) and np.isfinite(rew).all()):
        raise RuntimeError(f'VecEnv {mode}: rewards {rew}')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    timeouts, successes = np.asarray(timeouts), np.asarray(successes)
    want_keys = {'lcd', 'full_state', 'proprio', 'goal:lcd', 'goal:proprio'}
    if mode == 'cube':
      want_keys |= {'goal:full_state', 'goal:object'}
    log(f'[vec-env] {name} {mode} mode, {VEC_ENVS} envs x {steps} steps: '
        f'{wall * 1e3 / steps:.2f} ms a step on {smi}; launches {launches}; '
        f'timeouts at steps {sorted({int(t) + 1 for t in np.nonzero(timeouts)[0]})}, '
        f'{int(successes.sum())} successes')
    if set(obs) != want_keys:
      raise RuntimeError(f'VecEnv {mode} obs keys {sorted(obs)}')
    if (launches['lcd_raster'] < steps or launches != _expect(
        lcd_raster=launches['lcd_raster'])):
      raise RuntimeError(f'VecEnv {mode} launches {launches}')
    # a world times out at step ep_len unless a success reset it before
    early = successes[:ep_len - 1].any(0)
    if mode == 'body' and not (
        (timeouts[ep_len - 1] | early).all()
        and not np.delete(timeouts, ep_len - 1, 0).any()):
      raise RuntimeError(f'VecEnv timeouts do not fall on ep_len {ep_len}')
    out[mode] = dict(ms_a_step=wall * 1e3 / steps, steps=steps,
                     launches=launches, successes=int(successes.sum()))
  return out


class RecordingWriter:
  """The writer's surface; keeps the tags evaluate logged."""

  def __init__(self):
    self.tags = []

  def add_scalar(self, tag, *a, **k):
    self.tags.append(tag)

  add_image = add_video = add_scalar

  def flush(self):
    pass


def _losses(history, label, key='loss/total'):
  """The logged losses under `key`; all finite (callers check that the last
  is below the first)."""
  losses = [float(line[key]) for _, line in history]
  log(f'[wm] {label} logged losses at steps '
      f'{[itr for itr, _ in history]}: {losses}')
  if len(losses) < 2 or not np.isfinite(losses).all():
    raise RuntimeError(f'{label}: losses {losses}')
  return losses


def _wm_collect(data):
  """Collection through the CLI into native barrels; launches counted."""
  _zero_launches()
  t0 = time.perf_counter()
  research_main.main([
      '--mode=collect', f'--logdir={data}',
      f'--train_barrels={WM_BARRELS["train"]}',
      f'--test_barrels={WM_BARRELS["test"]}', f'--num_envs={BARREL_SIZE}',
      '--barrel_format=native', *WM_COMMON])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _launches()
  n = sum(WM_BARRELS.values())
  log(f'[wm] collect (research.main, native barrels) {n} x {BARREL_SIZE} '
      f'episodes: {wall:.2f} s; launches {launches}')
  if launches != _expect(mega_rollout=n, traj_raster=n, lcd_raster=n):
    raise RuntimeError(f'collect launches {launches}: one dispatch a barrel')
  for sub, count in WM_BARRELS.items():
    files = sorted((data / sub).glob('*.tbarrel.npz'))
    if len(files) != count:
      raise RuntimeError(f'{sub}: {len(files)} native barrels, not {count}')
    ds = RolloutDataset(data / sub, infinite=False)
    for f in files:
      lcd = ds._load(f)['lcd']
      if lcd.shape[0] != BARREL_SIZE or lcd.shape[2:] != (16, 32) or \
          lcd.all() or not lcd.any():
        raise RuntimeError(f'{f.name}: lcd {lcd.shape}')
  return dict(wall_s=wall, launches=launches)


def _wm_writes(dev, smi, tmp):
  """One megakernel dispatch written as npz and as native: the same arrays
  back, and each format's write ms (host clock)."""
  env = _env(MAIN_ENV, dev)
  fn, T = make_mega_rollout_fn(env, pack_lcd=True)
  traj = {k: v.cpu().numpy() for k, v in fn(
      torch.Generator(device=dev).manual_seed(1), BARREL_SIZE).items()}
  if not traj.pop('obs_ok'):
    raise RuntimeError('tripwire: traj raster frames differ')
  ms, loaded, size = {}, {}, {}
  for fmt in ('npz', 'native'):
    folder = tmp / f'writes_{fmt}'
    folder.mkdir()
    ms[fmt] = []
    for r in range(WM_WRITES):
      t0 = time.perf_counter()
      write_barrel_file(folder, r, T, env.lcd_w, traj, fmt)
      ms[fmt].append((time.perf_counter() - t0) * 1e3)
    files = sorted(folder.iterdir())
    size[fmt] = files[0].stat().st_size
    loaded[fmt] = RolloutDataset(folder, infinite=False)._load(files[0])
  a, b = loaded['npz'], loaded['native']
  if set(a) != set(b) or any(not np.array_equal(a[k], b[k]) for k in a):
    raise RuntimeError('npz and native barrels decode differently')
  if not np.array_equal(a['lcd'], np.unpackbits(traj['lcd'], axis=-1)):
    raise RuntimeError('barrel frames differ from the dispatch')
  log(f'[wm] barrel write, one dispatch ({BARREL_SIZE} x {T}, Urchin): '
      f'npz {ms["npz"]} ms ({size["npz"]} B), native {ms["native"]} ms '
      f'({size["native"]} B) (host clock, {WM_WRITES} writes each) on '
      f'{smi}; both decode to the same arrays')
  return dict(write_ms=ms, bytes=size)


def _wm_train(argv):
  G, env = research_main.parse_flags(['--mode=train', *argv])
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  model, history = research_main.train(G, env)
  torch.cuda.synchronize()
  return model, history, time.perf_counter() - t0


def _step_times(label, step, frames, smi):
  """ms a train step (host clock around synchronised repeats), the peak
  memory of those steps, and the device's busy share of a step (profiled
  device time over wall time) with its device events."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  ms = wall_ms(step, WM_TIMED_STEPS)
  peak = torch.cuda.max_memory_allocated()
  dev_ms, events = profiled(step, 5)
  log(f'[wm] {label}: {ms:.3f} ms a step, {1e3 / ms:.1f} steps/s, '
      f'{frames * 1e3 / ms:.1f} frames/s, peak {peak / 2**20:.1f} MiB '
      f'({WM_TIMED_STEPS} steps, synchronised); device {_fmt(dev_ms)} a '
      f'step in {events:.0f} events (profiler) on {smi}')
  return dict(ms=ms, steps_per_s=1e3 / ms, frames_per_s=frames * 1e3 / ms,
              peak_bytes=peak, device_ms=dev_ms, events=events)


def _wm_outputs(bvae, fbt, bbatch, fbatch, u, precision='float32'):
  """The BVAE's z and frame logits and loss, and the FBT's token logits and
  loss, on one fixed batch each; tensors on the CPU."""
  flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in bbatch.items()}
  with torch.no_grad(), autocast(bvae.device, precision):
    z_e = bvae.module.enc(flat['lcd'], flat['proprio'])
    dec = bvae.module.dec(torch.sigmoid(z_e))
    bloss, _ = bvae.loss_fn(bbatch, u=u.to(bvae.device))
    flogits = fbt.module(fbt._latents(fbatch), fbatch['action'])
    floss, _ = fbt.loss_fn(fbatch)
  return {'bvae_z_logits': z_e.float().cpu(),
          'bvae_lcd_logits': dec['lcd'].logits.float().cpu(),
          'fbt_logits': flogits.float().cpu(),
          'bvae_loss': float(bloss), 'fbt_loss': float(floss)}


def _wm_errors(got, want):
  """Largest logit differences (absolute) and loss differences (relative)."""
  errs = {k: float((got[k] - want[k]).abs().max())
          for k in ('bvae_z_logits', 'bvae_lcd_logits', 'fbt_logits')}
  for m in ('bvae', 'fbt'):
    a, b = got[f'{m}_loss'], want[f'{m}_loss']
    errs[f'{m}_loss_rel'] = abs(a - b) / abs(b)
    errs[f'{m}_losses'] = (a, b)
  return errs


def _card_vs_cpu(bvae, fbt, bbatch, fbatch):
  """The card's BVAE and FBT forwards and losses against the same modules
  (same state dict) on the CPU, from one fixed batch; the same on the card
  with TF32 on (a control: what the gate must tell apart from float32);
  and the bfloat16-autocast losses against the float32 ones on the card."""
  env = _env(MAIN_ENV, 'cpu')
  bcpu = BVAE(env, AttrDict(bvae.G, device='cpu'))
  bcpu.module.load_state_dict(bvae.module.state_dict())
  fcpu = FBT(env, AttrDict(fbt.G, device='cpu'), bvae=bcpu)
  fcpu.module.load_state_dict(fbt.module.state_dict())
  cpu = lambda b: {k: v.cpu() for k, v in b.items()}
  frames = bbatch['lcd'].shape[0] * bbatch['lcd'].shape[1]
  u = torch.rand((frames, bvae.zH, bvae.zW, bvae.G.vqD),
                 generator=torch.Generator().manual_seed(0))
  want = _wm_outputs(bcpu, fcpu, cpu(bbatch), cpu(fbatch), u)
  card = _wm_outputs(bvae, fbt, bbatch, fbatch, u)
  set_tf32(True)
  try:
    tf32 = _wm_outputs(bvae, fbt, bbatch, fbatch, u)
  finally:
    set_tf32(False)
  bf16 = _wm_outputs(bvae, fbt, bbatch, fbatch, u, precision='bfloat16')
  errs = _wm_errors(card, want)
  control = _wm_errors(tf32, want)
  bf16_errs = _wm_errors(bf16, card)
  log(f'[wm] card vs CPU (float32 both, TF32 off, same state dict; BVAE '
      f'{frames} frames, FBT {WM_CPU_FBT_EPISODES} x {fbt.block_size} '
      f'tokens): {errs}; bounds: logits {WM_LOGIT_TOL} abs, losses '
      f'{WM_LOSS_RTOL} rel')
  log(f'[wm] control, card with TF32 on vs CPU: {control}; must break '
      f'the logit bound')
  log(f'[wm] bfloat16 autocast vs float32 on the card, same batch: '
      f'{bf16_errs}; bound: losses {WM_BF16_LOSS_RTOL} rel')
  if max(errs['bvae_z_logits'], errs['bvae_lcd_logits'],
         errs['fbt_logits']) > WM_LOGIT_TOL or max(
             errs['bvae_loss_rel'], errs['fbt_loss_rel']) > WM_LOSS_RTOL:
    raise RuntimeError(f'card and CPU forwards differ: {errs}')
  if max(control['bvae_z_logits'], control['bvae_lcd_logits'],
         control['fbt_logits']) <= WM_LOGIT_TOL:
    raise RuntimeError(f'the gate cannot tell TF32 from float32: {control}')
  if max(bf16_errs['bvae_loss_rel'],
         bf16_errs['fbt_loss_rel']) > WM_BF16_LOSS_RTOL:
    raise RuntimeError(f'bfloat16 and float32 losses differ: {bf16_errs}')
  return dict(errs, tf32_control=control, bf16_vs_float32=bf16_errs)


def world_model_phase(dev, smi, tmp):
  """collect -> BVAE -> FBT -> KV-cached sampling on the card, through the
  port's research.main at kicker.py's widths on Urchin, in `tmp` (data/,
  bvae/, fbt/: the evaluation phase reads them). Returns the results and
  (bvae, fbt)."""
  out = {}
  data, bdir = tmp / 'data', tmp / 'bvae'
  out['collect'] = _wm_collect(data)
  out.update(_wm_writes(dev, smi, tmp))

  flags = [f'--datadir={data}', f'--total_itr={WM_STEPS}',
           f'--log_n={WM_LOG_N}', *WM_COMMON]
  bvae, bhist, bs = _wm_train(['--model=BVAE', f'--logdir={bdir}',
                               *flags, *WM_BVAE])
  fbt, fhist, fs = _wm_train([
      '--model=FBT', f'--logdir={tmp / "fbt"}', f'--weightdir={bdir}',
      '--device_dataset=1', f'--steps_per_dispatch={WM_LOG_N}', *flags,
      *WM_FBT])
  fbt2, f2hist, f2s = _wm_train([
      '--model=FBT', f'--logdir={tmp / "fbt_trainer"}',
      f'--weightdir={bdir}', '--device_dataset=0', f'--datadir={data}',
      f'--total_itr={WM_TRAINER_FBT_STEPS}',
      f'--log_n={WM_TRAINER_FBT_STEPS}', *WM_COMMON, *WM_FBT])
  losses = {'bvae': _losses(bhist, 'BVAE (Trainer)'),
            'fbt': _losses(fhist, 'FBT (device dataset)'),
            'fbt_trainer': _losses(f2hist, 'FBT (Trainer)')}
  for k in ('bvae', 'fbt'):
    if not losses[k][-1] < losses[k][0]:
      raise RuntimeError(f'{k}: the last logged loss is not below the '
                         f'first: {losses[k]}')
  log(f'[wm] params: BVAE {bvae.num_vars:,}, FBT {fbt.num_vars:,}; train '
      f'wall BVAE {bs:.1f} s, FBT {fs:.1f} s ({WM_STEPS} steps each, '
      f'evaluates and saves included), FBT Trainer {f2s:.1f} s')

  # precompute_z over the train barrels, its peak memory
  ds = DeviceDataset(data / 'train', device=dev)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = torch.cuda.memory_allocated()
  t0 = time.perf_counter()
  z = fbt.precompute_z(ds.data, unpack=ds.unpack_lcd)
  torch.cuda.synchronize()
  pz_ms = (time.perf_counter() - t0) * 1e3
  pz_peak = torch.cuda.max_memory_allocated()
  log(f'[wm] precompute_z: {ds.n_episodes} episodes x {ds.ep_len} frames '
      f'in {pz_ms:.1f} ms, peak {pz_peak / 2**20:.1f} MiB '
      f'({before / 2**20:.1f} MiB before) on {smi}')

  # ms a train step at the full widths
  gen = torch.Generator(device=dev).manual_seed(0)
  zdata = {'z': z, 'action': ds.data['action']}
  bb, bw, fb, fw = bvae.G.bs, bvae.G.window, fbt.G.bs, fbt.G.window
  bbatch = ds.sample(gen, bb, bw)
  steps = {}
  for prec in ('float32', 'bfloat16'):
    steps[f'bvae_{prec}'] = _step_times(
        f'BVAE update, {prec} (bs {bb} x window {bw})',
        lambda: bvae.update(bbatch, gen, precision=prec), bb * bw, smi)
    run = make_device_trainer(fbt, ds, fb, fw, 1, matmul_precision=prec)
    steps[f'fbt_{prec}'] = _step_times(
        f'FBT device-trainer step, {prec} (bs {fb} x window {fw}, batch '
        f'gather included)', lambda: run(gen, zdata), fb * fw, smi)

  # evaluate: the proprio re-render launches the lcd raster
  evals = {}
  for name, model in (('bvae', bvae), ('fbt', fbt)):
    batch = next(RolloutDataset(data / 'test', window=model.G.window)
                 .batches(model.G.bs))
    writer = RecordingWriter()
    _zero_launches()
    metrics = model.evaluate(writer, batch, WM_STEPS)
    torch.cuda.synchronize()
    launches = _launches()
    log(f'[wm] {name} evaluate: {metrics}; launches {launches}')
    if launches != _expect(lcd_raster=2):
      raise RuntimeError(f'{name} evaluate launches {launches}')
    evals[name] = dict(metrics=metrics, launches=launches)

  # KV-cached vs uncached sampling from one generator state; each path
  # warmed once (the float64 copy is made on the first call), the second
  # reading of each kept
  g = torch.Generator(device=dev).manual_seed(7)
  state = g.get_state()
  samples, sample_ms = {}, {}
  for use_cache in (True, False, True, False):
    g.set_state(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples[use_cache] = fbt.sample(g, WM_SAMPLE_N, use_cache=use_cache)
    torch.cuda.synchronize()
    sample_ms[use_cache] = (time.perf_counter() - t0) * 1e3
  for k in samples[True]:
    if not torch.equal(samples[True][k], samples[False][k]):
      raise RuntimeError(f'cached and uncached samples differ in {k}')
  frames = WM_SAMPLE_N * fbt.block_size
  sample_dev = {c: profiled(lambda: fbt.sample(g, WM_SAMPLE_N,
                                               use_cache=c), 1)
                for c in (True, False)}
  log(f'[wm] FBT.sample n={WM_SAMPLE_N} x {fbt.block_size}: cached '
      f'{sample_ms[True]:.1f} ms ({frames * 1e3 / sample_ms[True]:.1f} '
      f'frames/s), uncached {sample_ms[False]:.1f} ms '
      f'({frames * 1e3 / sample_ms[False]:.1f} frames/s), warm, float64 '
      f'serving (its copy made before), on {smi}; '
      f'bit for bit equal; device (profiler) cached '
      f'{_fmt(sample_dev[True][0])} in {sample_dev[True][1]:.0f} events, '
      f'uncached {_fmt(sample_dev[False][0])} in '
      f'{sample_dev[False][1]:.0f} events')

  fbatch = ds.sample(gen, WM_CPU_FBT_EPISODES, fw, zdata)
  errs = _card_vs_cpu(bvae, fbt, bbatch, fbatch)
  return dict(out, losses=losses, params={'bvae': bvae.num_vars,
                                          'fbt': fbt.num_vars},
              train_wall_s={'bvae': bs, 'fbt': fs, 'fbt_trainer': f2s},
              precompute_z=dict(ms=pz_ms, peak_bytes=pz_peak,
                                before_bytes=before),
              steps=steps, evaluate=evals,
              sample=dict(cached_ms=sample_ms[True],
                          uncached_ms=sample_ms[False],
                          frames_per_s=frames * 1e3 / sample_ms[True],
                          device=sample_dev),
              card_vs_cpu=errs), (bvae, fbt)

# the JAX Evaler's logger.pkl entries (tests/test_evaler.py:48-53, and
# proprio_log_mse: Urchin has proprio), per split
EV_KEYS = ['u:action_log_mse', 'u:fvd', 'u:precision', 'u:recall', 'u:f1',
           'p:ssim', 'p:psnr', 'p:proprio_log_mse', 'p:action_log_mse',
           'p:true_action_log_mse', 'p:cosdist', 'p:fvd', 'p:precision',
           'p:recall', 'p:f1']
# the loss each model's training must lower; VQVAE's total holds a codebook
# term that first climbs (x10-50 within 20-100 steps) as the encoder leaves
# the near-zero codebook, in the JAX package as in the port (the two track
# each other to 3 digits over 60 CPU steps), so its frame loss is read
EV_LOSS_KEY = {'MultiStepArbiter': 'loss/recon_total',
               'ArbiterAE': 'loss/recon_total', 'VAE': 'loss/vae_loss',
               'VQVAE': 'loss/recon_lcd', 'ObjectLocalizer': 'loss'}


def _ev_train(name, logdir, data, steps, extra, smi):
  """One model through research.main --mode=train (the Trainer), its
  logged losses finite and the last below the first, then ms a train step
  at its batch (bs x window frames) and its parameter count."""
  model, history, wall = _wm_train([
      f'--model={name}', f'--logdir={logdir}', f'--datadir={data}',
      f'--total_itr={steps}', f'--log_n={WM_LOG_N}', *WM_COMMON, *extra])
  losses = _losses(history, name, EV_LOSS_KEY.get(name, 'loss/total'))
  if not losses[-1] < losses[0]:
    raise RuntimeError(f'{name}: the last logged loss is not below the '
                       f'first: {losses}')
  G = model.G
  batch = to_device(next(RolloutDataset(Path(data) / 'train', window=G.window)
                         .batches(G.bs)), model.device)
  gen = torch.Generator(device=model.device).manual_seed(0)
  step = _step_times(f'{name} update, float32 (bs {G.bs} x window '
                     f'{G.window})', lambda: model.update(batch, gen),
                     G.bs * G.window, smi)
  log(f'[ev] {name}: {model.num_vars:,} params; {steps} steps through the '
      f'Trainer in {wall:.1f} s (evaluates and saves included) on {smi}')
  return model, dict(params=model.num_vars, losses=losses, train_s=wall,
                     step=step)


def _ev_outputs(name, model, batch):
  """The frozen surfaces (features, action predictions, locations) and the
  loss of one model on one batch; tensors on the CPU."""
  with torch.no_grad():
    loss, _ = model.loss_fn(batch)
    if name == 'MultiStepArbiter':
      out = dict(zip(('z', 'action'), model.forward_frozen(batch)))
    else:
      flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
      if name == 'ArbiterAE':
        out = {'z': model.encode(flat)}
        out['lcd_logits'] = model.decode(out['z'])['lcd'].logits
      else:
        out = dict(zip(('mean', 'std'), model.module(flat['lcd'],
                                                     flat['proprio'])))
        out['target'] = flat['full_state'][:, torch.as_tensor(model.idxs)]
  return {k: v.float().cpu() for k, v in out.items()}, float(loss)


def _nll_slack(got, want):
  """The change of the localizer's loss, the mean over elements of
  -log N(x; m, s), that its outputs' differences explain to first order:
  |x - m| / s^2 a unit of mean, |1/s - (x - m)^2 / s^3| a unit of std. A
  learned std of ~0.01-0.1 scales them by 1e2-1e4, so equal functions
  with float32 outputs 1e-7 apart give losses ~1e-5 apart."""
  m, s, x = want['mean'], want['std'], want['target']
  dm, ds = (got['mean'] - m).abs(), (got['std'] - s).abs()
  return float(((x - m).abs() / s ** 2 * dm
                + (1 / s - (x - m) ** 2 / s ** 3).abs() * ds).mean())


def _ev_card_vs_cpu(models, batches):
  """Each model on the card against the same state dict on the CPU, float32
  (TF32 off) on one fixed batch: outputs within WM_LOGIT_TOL, the loss
  within WM_LOSS_RTOL relative (phase 12's gates); the localizer's loss
  within that plus twice what its outputs' differences explain
  (`_nll_slack`)."""
  errs = {}
  for name, (model, env_name) in models.items():
    cpu = type(model)(_env(env_name, 'cpu'), AttrDict(model.G, device='cpu'))
    cpu.module.load_state_dict(model.module.state_dict())
    batch = batches[env_name]
    got, loss = _ev_outputs(name, model, batch)
    want, want_loss = _ev_outputs(name, cpu, {k: v.cpu()
                                              for k, v in batch.items()})
    errs[name] = {k: float((got[k] - want[k]).abs().max()) for k in want}
    errs[name]['loss_rel'] = abs(loss - want_loss) / abs(want_loss)
    errs[name]['loss_tol_rel'] = WM_LOSS_RTOL
    if name == 'ObjectLocalizer':
      errs[name]['std_range'] = (float(want['std'].min()),
                                 float(want['std'].max()))
      errs[name]['loss_tol_rel'] += 2 * _nll_slack(got, want) / abs(want_loss)
  log(f'[ev] card vs CPU (float32 both, TF32 off, same state dict, '
      f'{EV_CPU_BATCH} episodes): {errs}; bounds: outputs {WM_LOGIT_TOL} '
      f'abs, losses loss_tol_rel ({WM_LOSS_RTOL}, the localizer\'s plus '
      f'twice the NLL change its output differences explain)')
  for name, e in errs.items():
    if max(e[k] for k in ('z', 'action', 'lcd_logits', 'mean', 'std')
           if k in e) > WM_LOGIT_TOL or e['loss_rel'] > e['loss_tol_rel']:
      raise RuntimeError(f'{name}: card and CPU differ: {e}')
  return errs


def _ev_evaluate(label, model, data, arbiter, want):
  """`evaluate` with a frozen arbiter and a writer: the metrics in `want`
  finite, the lcd raster launched twice (the proprio re-render)."""
  batch = next(RolloutDataset(data / 'test', window=model.G.window)
               .batches(model.G.bs))
  _zero_launches()
  metrics = model.evaluate(RecordingWriter(), batch, 0, arbiter=arbiter)
  torch.cuda.synchronize()
  launches = _launches()
  log(f'[ev] {label} evaluate, frozen {arbiter["kind"]}: {metrics}; '
      f'launches {launches}')
  if launches != _expect(lcd_raster=2):
    raise RuntimeError(f'{label} evaluate launches {launches}')
  missing = [k for k in want if not np.isfinite(metrics.get(k, np.nan))]
  if missing:
    raise RuntimeError(f'{label} evaluate: {missing} missing or not finite')
  return dict(metrics=metrics, launches=launches)


def _ev_localizer(tmp, smi):
  """UrchinCube collection through research.main (native barrels, launches
  counted), the ObjectLocalizer trained on it, its error on a test batch,
  and its frozen file read back."""
  data = tmp / 'cube_data'
  _zero_launches()
  t0 = time.perf_counter()
  research_main.main([
      '--mode=collect', f'--logdir={data}',
      f'--train_barrels={EV_LOC_BARRELS["train"]}',
      f'--test_barrels={EV_LOC_BARRELS["test"]}', f'--num_envs={BARREL_SIZE}',
      '--barrel_format=native', *WM_COMMON, f'--env={EV_LOC_ENV}'])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _launches()
  n = sum(EV_LOC_BARRELS.values())
  log(f'[ev] collect {EV_LOC_ENV} (research.main, native) {n} x '
      f'{BARREL_SIZE} episodes: {wall:.2f} s on {smi}; launches {launches}')
  if launches != _expect(mega_rollout=n, traj_raster=n, lcd_raster=n):
    raise RuntimeError(f'collect launches {launches}: one dispatch a barrel')
  loc, res = _ev_train('ObjectLocalizer', tmp / 'loc', data, EV_LOC_STEPS,
                       ['--window=5', f'--env={EV_LOC_ENV}'], smi)
  batch = to_device(next(RolloutDataset(data / 'test', window=5)
                         .batches(loc.G.bs)), loc.device)
  flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
  with torch.no_grad():
    xy = loc.localize(flat['lcd'], flat['proprio'])
  target = flat['full_state'][:, torch.as_tensor(loc.idxs)]
  mae = (xy - target).abs().mean(0).tolist()
  const = (target - target.mean(0)).abs().mean(0).tolist()
  log(f'[ev] localizer on {xy.shape[0]} test frames ({loc.keys}): mean abs '
      f'error {mae} (a constant at the batch mean: {const}) on {smi}')
  if not np.isfinite(mae).all():
    raise RuntimeError(f'localizer error {mae}')
  path = loc.save_frozen(tmp / 'loc')
  with open(path, 'rb') as f:
    blob = pickle.load(f)
  back = ObjectLocalizer(loc.env, AttrDict(blob['G']))
  back.module.load_state_dict(blob['state_dict'])
  with torch.no_grad():
    if not torch.equal(back.localize(flat['lcd'], flat['proprio']), xy):
      raise RuntimeError('the frozen localizer reads back differently')
  return loc, data, dict(res, collect=dict(wall_s=wall, launches=launches),
                         mae=mae, const_mae=const)


def evaluation_phase(dev, smi, tmp, bvae, fbt):
  """The evaluation chain on the card through research.main: the two
  arbiters, the other autoencoders and the object localizer trained; both
  evaluates with a frozen arbiter; --mode=eval over phase 12's FBT; and the
  new models on the card against the CPU."""
  data = tmp / 'data'
  adir, aedir = tmp / 'msarb', tmp / 'arbae'
  out = {}
  msarb, out['MultiStepArbiter'] = _ev_train(
      'MultiStepArbiter', adir, data, EV_ARB_STEPS, EV_ARBITER, smi)
  arbae, out['ArbiterAE'] = _ev_train(
      'ArbiterAE', aedir, data, EV_ARB_STEPS, EV_ARBITER_AE, smi)
  for name, extra in EV_AES.items():
    _, out[name] = _ev_train(name, tmp / name, data, EV_AE_STEPS, extra, smi)
  loc, cube_data, out['ObjectLocalizer'] = _ev_localizer(tmp, smi)

  ae_arb = load_arbiter(AttrDict(arbiterdir=aedir), bvae.env)
  ms_arb = load_arbiter(AttrDict(arbiterdir=adir), fbt.env)
  if (ae_arb['kind'], ms_arb['kind'], ms_arb['window']) != (
      'ArbiterAE', 'MultiStepArbiter', 47):
    raise RuntimeError(f'arbiters {ae_arb["kind"]} {ms_arb["kind"]}')
  out['evaluate'] = {
      'bvae': _ev_evaluate('BVAE', bvae, data, ae_arb,
                           ['eval/fid', 'eval/cosdist']),
      'fbt': _ev_evaluate('FBT', fbt, data, ms_arb, [
          'eval/unprompted_fvd', 'eval/unprompted_precision',
          'eval/unprompted_recall', 'eval/unprompted_f1',
          'eval/unprompted_action_log_mse', 'eval/prompted_cosdist',
          'eval/prompted_action_log_mse',
          'eval/prompted_true_action_log_mse'])}

  # --mode=eval: the Evaler over phase 12's FBT with the MultiStepArbiter
  G, env = research_main.parse_flags([
      '--mode=eval', '--model=FBT', f'--weightdir={tmp / "fbt"}',
      f'--arbiterdir={adir}', f'--logdir={tmp / "eval"}', f'--datadir={data}',
      f'--eval_n={EV_EVAL_N}', *WM_COMMON, *EV_FBT])
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  evaler, final = research_main.evaluate(G, env)
  wall = time.perf_counter() - t0
  with open(tmp / 'eval' / 'logger.pkl', 'rb') as f:
    table = pickle.load(f)
  want = {f'{split}:{k}' for split in ('test', 'train') for k in EV_KEYS}
  bad = [k for k, v in table.items() if not np.isfinite(v).all()]
  if set(table) != want or table != final or bad:
    raise RuntimeError(f'logger.pkl: {sorted(set(table) ^ want)} differ, '
                       f'{bad} not finite')
  per_rep = -(-EV_EVAL_N // G.bs) * G.bs * 2 * 2   # batches x (u, p) x splits
  log(f'[ev] Evaler, FBT x MultiStepArbiter, {EV_REPS} reps of eval_n '
      f'{EV_EVAL_N} (bs {G.bs}, 50 frames a sample): {wall:.1f} s; '
      f'{evaler.rep_s} s a rep, {per_rep / np.mean(evaler.rep_s):.1f} '
      f'samples/s on {smi}')
  log(f'[ev] logger.pkl: { {k: table[k] for k in sorted(table)} }')
  out['evaler'] = dict(wall_s=wall, rep_s=evaler.rep_s,
                       samples_per_rep=per_rep, table=table)

  batches = {MAIN_ENV: to_device(next(RolloutDataset(
      data / 'test', window=47).batches(EV_CPU_BATCH)), dev)}
  batches[EV_LOC_ENV] = to_device(next(RolloutDataset(
      cube_data / 'test', window=5).batches(EV_CPU_BATCH)), dev)
  models = {'MultiStepArbiter': (msarb, MAIN_ENV),
            'ArbiterAE': (arbae, MAIN_ENV),
            'ObjectLocalizer': (loc, EV_LOC_ENV)}
  out['card_vs_cpu'] = _ev_card_vs_cpu(models, batches)
  return out


# phase 14, video models and the learned env: on phase 12's Urchin data,
# BVAE and FBT and phase 13's RNLDA, MultiStepArbiter and ObjectLocalizer
VM_FLAGS = {   # research/scripts/kicker.py's presets
    'FIT': ['--n_layer=2', '--n_head=4', '--n_embed=256',
            '--hidden_size=256'],                              # kicker.py:26
    'RSSM': ['--nfilter=64', '--hidden_size=300', '--free_nats=0.01'],  # :24
    'FRNLD': ['--n_layer=4', '--n_head=8', '--n_embed=512',
              '--hidden_size=512'],                            # kicker.py:30
}
VM_COMMON = ['--window=50', '--prompt_n=3']   # kicker.py:35, :37, as FBT's
VM_STEPS = 100                  # kicker.py runs 1e5
VM_EVAL_N = 128                 # G.eval_n 2048, cut; --mode=eval's 5 reps
VM_CPU_BATCH = 16               # the card-vs-CPU batch, episodes x 50
LENV_ENVS = 128                 # research/scripts/headline_rl.sh --num_envs
LENV_STEPS = 101                # ep_len 100 + 1: one timeout's full reset
LENV_OTHER_STEPS = 20           # the FRNLD and cube-goal learned envs
LENV_PREPROC_STEPS = 5
LENV_PROFILED = 10              # steps timed and profiled
# a card-vs-CPU learned-env step: the z draws equal wherever |p - u| is
# above this margin, the decoded frames wherever |prob - 0.5| is
LENV_MARGIN = 1e-4


def _vm_cpu_twin(name, model, cpu_env):
  """The same model on the CPU with the card's state dict (FRNLD with its
  RNLDA's)."""
  G = AttrDict(model.G, device='cpu')
  if name == 'FRNLD':
    ron = type(model.ronald)(cpu_env, AttrDict(model.ronald.G, device='cpu'))
    ron.module.load_state_dict(model.ronald.module.state_dict())
    cpu = type(model)(cpu_env, G, ronald=ron)
  else:
    cpu = type(model)(cpu_env, G)
  cpu.module.load_state_dict(model.module.state_dict())
  return cpu


def _vm_outputs(name, model, batch, eps, z=None):
  """One video model's outputs and loss on one batch (CPU tensors, a
  float): FIT's logits; RSSM's embedding, posterior and prior means and
  frame logits, fed the normals eps; FRNLD's RNLDA encoder logits, its
  latents, and its transformer's outputs and loss (FRNLD.loss_fn's
  formula) on the latents z, the CPU's, since a latent within a float32
  rounding of a bin edge may quantize apart on the two devices."""
  dev = model.device
  with torch.no_grad():
    if name == 'FIT':
      loss, _ = model.loss_fn(batch)
      B, T = batch['lcd'].shape[:2]
      out = {'logits': model.module(batch['lcd'].reshape(B, T, -1),
                                    batch['action'])}
    elif name == 'RSSM':
      eps = tuple(e.to(dev) for e in eps)
      loss, _ = model.loss_fn(batch, eps=eps)
      emb = model._embed(batch['lcd'], batch['proprio'])
      posts, priors = model.observe(emb[:, 1:], batch['action'][:, :-1],
                                    eps=eps)
      feat = torch.cat([posts['stoch'], posts['deter']], -1)
      out = {'embed': emb, 'post_mean': posts['mean'],
             'prior_mean': priors['mean'],
             'lcd_logits': model.module.decode(
                 feat.reshape(-1, feat.shape[-1]))['lcd'].logits}
    else:
      flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
      ron = model.ronald
      out = {'z_logits': ron.module.enc(flat['lcd'], flat['proprio']),
             'z': ron.encode(batch, noise=False)}
      zz = out['z'] if z is None else z.to(dev)
      out['out'] = model.module(zz, batch['action'])
      loss = ((torch.tanh(out['out']) - zz) ** 2).mean()
  return {k: v.float().cpu() for k, v in out.items()}, float(loss)


def _vm_card_vs_cpu(models, batch):
  """Each new video model on the card against the same state dict on the
  CPU, float32 (TF32 off) on one batch: outputs within WM_LOGIT_TOL, the
  loss within WM_LOSS_RTOL relative (phase 12's gates). FRNLD's latents
  are equal wherever tanh of the encoder's logit is more than LENV_MARGIN
  from a bin edge (-0.5, 0, 0.5)."""
  cpu_env = _env(MAIN_ENV, 'cpu')
  cpu_batch = {k: v.cpu() for k, v in batch.items()}
  B, T = batch['action'].shape[:2]
  g = torch.Generator().manual_seed(0)
  eps = (torch.randn((T - 1, B, 64), generator=g),
         torch.randn((T - 1, B, 64), generator=g))
  errs = {}
  for name, model in models.items():
    cpu = _vm_cpu_twin(name, model, cpu_env)
    want, want_loss = _vm_outputs(name, cpu, cpu_batch, eps)
    got, loss = _vm_outputs(name, model, batch, eps, z=want.get('z'))
    e = {k: float((got[k] - want[k]).abs().max()) for k in want if k != 'z'}
    if name == 'FRNLD':
      edge = torch.stack([(torch.tanh(want['z_logits']) - b).abs()
                          for b in (-0.5, 0.0, 0.5)]).amin(0)
      edge = edge.reshape(want['z'].shape)
      # a latent is a bin centre up to a rounding of its straight-through
      # z_q + (z - z); apart means another centre, 0.5 away
      apart = (got['z'] - want['z']).abs() > 0.25
      e['z_apart'] = int(apart.sum())
      e['z_apart_beyond_margin'] = int((apart & (edge > LENV_MARGIN)).sum())
    e['loss_rel'] = abs(loss - want_loss) / abs(want_loss)
    errs[name] = e
  log(f'[vm] card vs CPU (float32 both, TF32 off, same state dict, {B} '
      f'episodes x {T}): {errs}; bounds: outputs {WM_LOGIT_TOL} abs, losses '
      f'{WM_LOSS_RTOL} rel, FRNLD latents equal beyond {LENV_MARGIN} of a '
      f'bin edge')
  for name, e in errs.items():
    outs = [v for k, v in e.items() if k not in ('loss_rel', 'z_apart',
                                                 'z_apart_beyond_margin')]
    if max(outs) > WM_LOGIT_TOL or e['loss_rel'] > WM_LOSS_RTOL or \
        e.get('z_apart_beyond_margin', 0):
      raise RuntimeError(f'{name}: card and CPU differ: {e}')
  return errs


def _lenv_G(model, **kw):
  """The learned env's config: the model's, with the RL entry point's
  autoreset (research/rl/main.py sets it for goal envs); the other RL keys
  at their defaults."""
  return AttrDict(model.G, autoreset=1, **kw)


def _lenv_run(label, renv, steps, smi, timed=False):
  """A RewardLenv reset and stepped `steps` times with uniform random
  actions, the lcd raster's launches counted over it: 2 a full reset (the
  goals' real reset, the prompts') and 1 a per-row goal resample. Its
  observations, rewards and deltas finite, done on timeout. With `timed`,
  env-steps/s, ms a step and the busy share of LENV_PROFILED more steps."""
  env = renv.lenv
  dev, B = env.device, env.num_envs
  gen = torch.Generator(device=dev).manual_seed(5)
  act = lambda: uniform_actions(gen, (B, env.raw_env.act_size), dev)
  ok = torch.ones((), dtype=torch.bool, device=dev)
  finite = lambda d: torch.stack([torch.isfinite(v).all()
                                  for v in d.values()]).all()
  _zero_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  obs = renv.reset()
  ok &= finite(obs)
  full, resample, timeouts = 1, 0, []
  for t in range(steps):
    obs, rew, done, info = renv.step(act())
    ok &= finite(obs) & finite({'rew': rew, 'delta': info['delta']})
    if bool(info['timeout'].all()):
      full += 1
      timeouts.append(t + 1)
      ok &= done.all()
    elif bool(info['success'].any()):
      resample += 1
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _launches()
  want = _expect(lcd_raster=2 * full + resample)
  ep_len = int(env.G.ep_len)
  log(f'[lenv] {label}: {B} envs x {steps} steps in {wall:.2f} s, '
      f'{B * steps / wall:.1f} env-steps/s, {wall * 1e3 / steps:.2f} ms a '
      f'step (resets included) on {smi}; timeouts at steps {timeouts}, '
      f'{full} full resets, {resample} goal resamples; launches {launches}')
  if not bool(ok):
    raise RuntimeError(f'{label}: observations, rewards or deltas not '
                       f'finite, or not done on timeout')
  if timeouts != list(range(ep_len, steps + 1, ep_len)):
    raise RuntimeError(f'{label}: timeouts at {timeouts}, ep_len {ep_len}')
  if launches != want:
    raise RuntimeError(f'{label}: launches {launches}, not {want}')
  out = dict(wall_s=wall, steps=steps, envs=B,
             env_steps_per_s=B * steps / wall, ms_a_step=wall * 1e3 / steps,
             full_resets=full, goal_resamples=resample, launches=launches)
  if timed:
    step = lambda: renv.step(act())
    ms = wall_ms(step, LENV_PROFILED)
    dev_ms, events = profiled(step, LENV_PROFILED)
    busy = None if dev_ms is None else dev_ms / ms
    log(f'[lenv] {label}, {LENV_PROFILED} more steps: {ms:.3f} ms a step '
        f'(host clock, synchronised), {B * 1e3 / ms:.1f} env-steps/s; '
        f'device {_fmt(dev_ms)} a step in {events:.0f} events (profiler), '
        f'busy {busy} on {smi}')
    out.update(step_ms=ms, step_env_steps_per_s=B * 1e3 / ms,
               device_ms=dev_ms, events=events, busy=busy)
  return out


def _lenv_card_vs_cpu(renv):
  """One learned-env model step (FBT.onestep at the env's pointer) from the
  env's window batch and one set of uniforms u, on the card and on the CPU
  with the same state dicts, taken apart where float32 roundings may
  legitimately move a threshold: the window's BVAE codes equal wherever
  the code's probability is more than LENV_MARGIN from 0.5; from the same
  codes (the CPU's) the token probabilities p within WM_LOGIT_TOL and the
  z draws equal wherever |p - u| > LENV_MARGIN; from the same draws the
  frames equal wherever |prob - 0.5| > LENV_MARGIN and proprio within
  WM_LOGIT_TOL. The whole step's frames that agree on both are counted."""
  env = renv.lenv
  fbt, ptr, dev = env.model, env.ptr, env.device
  cpu_env = _env(MAIN_ENV, 'cpu')
  bcpu = BVAE(cpu_env, AttrDict(fbt.bvae.G, device='cpu'))
  bcpu.module.load_state_dict(fbt.bvae.module.state_dict())
  fcpu = FBT(cpu_env, AttrDict(fbt.G, device='cpu'), bvae=bcpu)
  fcpu.module.load_state_dict(fbt.module.state_dict())
  wb = env.window_batch
  wcpu = {k: v.cpu() for k, v in wb.items()}
  u = torch.rand((env.num_envs, fbt.z_size),
                 generator=torch.Generator().manual_seed(1))
  far = lambda x: (x - 0.5).abs() > LENV_MARGIN
  with torch.no_grad():
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in wcpu.items()}
    code_p = torch.sigmoid(bcpu.module.enc(flat['lcd'], flat['proprio']))
    both = (('card', fbt, wb), ('cpu', fcpu, wcpu))
    codes = {k: m.bvae.encode(b, noise=False).cpu() > 0.5
             for k, m, b in both}
    z = codes['cpu'].float()
    p = {k: torch.sigmoid(m.module(z.to(m.device), b['action'])[:, ptr]
                          ).cpu() for k, m, b in both}
    zi = {k: (u < v).float() for k, v in p.items()}
    dec = {k: m.bvae.decode(zi['cpu'].to(m.device)) for k, m, _ in both}
    card = fbt.onestep(wb, ptr, None, u=u.to(dev))
    cpu = fcpu.onestep(wcpu, ptr, None, u=u)
  code_apart = codes['card'] != codes['cpu']
  frames = {k: d['lcd'].probs.cpu() > 0.5 for k, d in dec.items()}
  probs = dec['cpu']['lcd'].probs
  same_frame = (card['lcd'][:, ptr].cpu() == cpu['lcd'][:, ptr]).reshape(
      env.num_envs, -1).all(-1)
  errs = dict(
      codes_apart=int(code_apart.sum()),
      codes_apart_beyond=int((code_apart & far(code_p).reshape(
          code_apart.shape)).sum()),
      p_err=float((p['card'] - p['cpu']).abs().max()),
      draws_in_margin=int(((p['cpu'] - u).abs() <= LENV_MARGIN).sum()),
      draws_apart_beyond=int(((zi['card'] != zi['cpu'])
                              & ((p['cpu'] - u).abs() > LENV_MARGIN)).sum()),
      frames_apart_beyond=int(((frames['card'] != frames['cpu'])
                               & far(probs)).sum()),
      pixels_in_margin=int((~far(probs)).sum()),
      proprio_err=float((dec['card']['proprio'].mean.cpu()
                         - dec['cpu']['proprio'].mean).abs().max()),
      whole_step_frames_equal=int(same_frame.sum()))
  log(f'[lenv] card vs CPU, one model step ({env.num_envs} envs, pointer '
      f'{ptr}, same window batch and uniforms, float32, TF32 off): {errs}; '
      f'gates: codes, draws and frames equal beyond {LENV_MARGIN}, p and '
      f'proprio within {WM_LOGIT_TOL}')
  if errs['codes_apart_beyond'] or errs['draws_apart_beyond'] or \
      errs['frames_apart_beyond'] or not max(
          errs['p_err'], errs['proprio_err']) <= WM_LOGIT_TOL:
    raise RuntimeError(f'learned env: card and CPU differ: {errs}')
  return errs


def learned_env_phase(dev, smi, tmp, bvae, fbt, frnld):
  """The world model served as an env on the card: RewardLenv(LearnedEnv)
  over phase 12's FBT (body goals, one timeout), over this phase's FRNLD,
  PreprocVecEnv over the FBT one with phase 12's BVAE, cube goals with
  phase 13's frozen ObjectLocalizer over an untrained UrchinCube BVAE +
  FBT at phase 12's widths, and one model step on the card against the
  CPU."""
  out = {}
  renv = RewardLenv(LearnedEnv(LENV_ENVS, fbt, _lenv_G(fbt)))
  out['fbt'] = _lenv_run('FBT learned env, Urchin body goals', renv,
                         LENV_STEPS, smi, timed=True)
  out['card_vs_cpu'] = _lenv_card_vs_cpu(renv)
  out['frnld'] = _lenv_run(
      'FRNLD learned env, Urchin body goals',
      RewardLenv(LearnedEnv(LENV_ENVS, frnld, _lenv_G(frnld))),
      LENV_OTHER_STEPS, smi)

  penv = PreprocVecEnv(bvae, RewardLenv(LearnedEnv(LENV_ENVS, fbt,
                                                   _lenv_G(fbt))), fbt.G)
  gen = torch.Generator(device=dev).manual_seed(6)
  obs = penv.reset()
  for t in range(LENV_PREPROC_STEPS + 1):
    with torch.no_grad():
      for k in ('', 'goal:'):
        z = bvae.encode({'lcd': obs[f'{k}lcd'], 'proprio': obs[f'{k}proprio']})
        if not torch.equal(obs[f'{k}zstate'], z):
          raise RuntimeError(f'PreprocVecEnv: {k}zstate is not the BVAE code')
    obs = penv.step(uniform_actions(gen, (LENV_ENVS, bvae.env.act_size),
                                    dev))[0]
  log(f'[lenv] PreprocVecEnv over the FBT learned env: zstate and '
      f'goal:zstate ({tuple(obs["zstate"].shape)}) equal the BVAE code at '
      f'{LENV_PREPROC_STEPS + 1} observations')

  flags = [*WM_COMMON, f'--env={EV_LOC_ENV}']
  bG, cenv = research_main.parse_flags(['--mode=train', *flags, *WM_BVAE])
  fG, _ = research_main.parse_flags([
      '--mode=train', *flags, *WM_FBT, f'--arbiterdir={tmp / "loc"}'])
  cbvae = BVAE(cenv, bG)
  cfbt = FBT(cenv, fG, bvae=cbvae)
  crenv = RewardLenv(LearnedEnv(LENV_ENVS, cfbt, _lenv_G(cfbt),
                                real_env=CubeGoalEnv(cenv, fG)))
  if crenv.obj_loc is None:
    raise RuntimeError('cube goals: no frozen ObjectLocalizer loaded')
  out['cube'] = _lenv_run('untrained FBT learned env, UrchinCube cube goals',
                          crenv, LENV_OTHER_STEPS, smi)
  return out


def video_model_phase(dev, smi, tmp):
  """FIT, RSSM and FRNLD (over phase 13's RNLDA) trained through
  research.main on phase 12's data, each one's evaluate with phase 13's
  MultiStepArbiter, --mode=eval over each, the three on the card against
  the CPU; then the learned env (`learned_env_phase`)."""
  data = tmp / 'data'
  out, models = {}, {}
  for name in ('FIT', 'RSSM', 'FRNLD'):
    extra = [*VM_COMMON, *VM_FLAGS[name]]
    if name == 'FRNLD':
      extra.append(f'--weightdir={tmp / "RNLDA"}')
    models[name], out[name] = _ev_train(name, tmp / name, data, VM_STEPS,
                                        extra, smi)
  arb = load_arbiter(AttrDict(arbiterdir=tmp / 'msarb'), models['FIT'].env)
  want = ['eval/unprompted_fvd', 'eval/unprompted_precision',
          'eval/unprompted_recall', 'eval/unprompted_f1',
          'eval/unprompted_action_log_mse', 'eval/prompted_cosdist',
          'eval/prompted_action_log_mse', 'eval/prompted_true_action_log_mse']
  out['evaluate'] = {name: _ev_evaluate(name, m, data, arb, want)
                     for name, m in models.items()}
  out['evaler'] = {}
  for name in models:
    G, env = research_main.parse_flags([
        '--mode=eval', f'--model={name}', f'--weightdir={tmp / name}',
        f'--arbiterdir={tmp / "msarb"}', f'--logdir={tmp / "eval" / name}',
        f'--datadir={data}', f'--eval_n={VM_EVAL_N}', *WM_COMMON,
        *VM_COMMON])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaler, final = research_main.evaluate(G, env)
    wall = time.perf_counter() - t0
    with open(tmp / 'eval' / name / 'logger.pkl', 'rb') as f:
      table = pickle.load(f)
    keys = {f'{split}:{k}' for split in ('test', 'train') for k in EV_KEYS}
    bad = [k for k, v in table.items() if not np.isfinite(v).all()]
    if set(table) != keys or table != final or bad:
      raise RuntimeError(f'{name} logger.pkl: {sorted(set(table) ^ keys)} '
                         f'differ, {bad} not finite')
    per_rep = -(-VM_EVAL_N // G.bs) * G.bs * 2 * 2
    log(f'[vm] Evaler, {name} x MultiStepArbiter, {len(evaler.rep_s)} reps '
        f'of eval_n {VM_EVAL_N} (bs {G.bs}): {wall:.1f} s; {evaler.rep_s} s '
        f'a rep, {per_rep / np.mean(evaler.rep_s):.1f} samples/s on {smi}')
    out['evaler'][name] = dict(wall_s=wall, rep_s=evaler.rep_s,
                               samples_per_rep=per_rep, table=table)
  batch = to_device(next(RolloutDataset(data / 'test', window=50)
                         .batches(VM_CPU_BATCH)), dev)
  out['card_vs_cpu'] = _vm_card_vs_cpu(models, batch)
  return out, models


# phase 15, RL: on phase 12's Urchin data and FBT, through the port's
# research.rl.main at research/scripts/headline_rl.sh:62-84's widths (128
# envs, minibatches of 4096, 256-wide nets, body goals, a test every 2nd
# epoch); ep_len 100 cut to 25 (each real-env test is ep_len VecEnv steps
# at 0.6-0.9 s)
RL_COMMON = ['--env=Urchin', '--vel_iters=8', '--pos_iters=4',
             '--num_envs=128', '--bs=4096', '--hidden_size=256',
             '--ep_len=25', '--test_n=2']
RL_LENV_EPOCHS = 2            # 375 fused steps each: the headline epoch
RL_PROFILED_STEPS = 25        # dream steps profiled for the busy share
RL_LENV = ['--lenv=1', '--model=FBT', '--steps_per_epoch=48000',
           f'--total_steps={48000 * RL_LENV_EPOCHS}', '--lenv_test=0']
RL_REAL_STEPS = 10            # the headline epoch's 375 steps, cut
RL_REAL = ['--lenv=0', f'--steps_per_epoch={128 * RL_REAL_STEPS}',
           f'--total_steps={128 * RL_REAL_STEPS}']
RL_EVAL_ITERS = 1             # eval_policy's ITERS 10 (N = 1000), cut
RL_EVAL = []                  # eval_policy's flags beside --logdir
# SAC's replay run: 16 envs, 2 random start steps, then one burst of
# update_every = 40 updates at minibatches of 512 (a 4096-row cnn batch
# of four 16x32 frames a row would gather 1.3 GB a burst on the host)
RL_SAC_RUN = ['--lenv=0', '--net=cnn', '--num_envs=16', '--bs=512',
              '--total_steps=48', '--start_steps=32', '--update_after=32',
              '--update_every=40']
RL_FIRE_ITERS = 50            # firehose iterations; one test, log and save
RL_SAC_FIRE = ['--lenv=1', '--model=FBT', '--net=mlp', '--firehose=1',
               f'--total_steps={RL_FIRE_ITERS}',
               f'--log_n={10 * RL_FIRE_ITERS}']


class ScalarWriter:
  """The writer's surface, keeping the logged scalars."""

  def __init__(self):
    self.scalars = []

  def add_scalar(self, tag, value, *a, **k):
    self.scalars.append((tag, float(value)))

  def add_image(self, *a, **k):
    pass

  add_video = add_image

  def flush(self):
    pass


class Timed:
  """Wraps methods of classes while the context lasts: each call's wall ms
  (synchronised before and after) and the lcd raster launches it made,
  kept in `calls[name]`."""

  def __init__(self, targets):
    self.targets = targets
    self.calls = {name: [] for _, name in targets}

  def _wrap(self, name, fn):
    def timed(*a, **k):
      torch.cuda.synchronize()
      lcd0 = trace.counter('lcd_raster.launches')
      t0 = time.perf_counter()
      out = fn(*a, **k)
      torch.cuda.synchronize()
      self.calls[name].append(dict(
          ms=(time.perf_counter() - t0) * 1e3,
          lcd=trace.counter('lcd_raster.launches') - lcd0))
      return out
    return timed

  def __enter__(self):
    self.saved = [(cls, name, cls.__dict__[name]) for cls, name in
                  self.targets]
    for cls, name, fn in self.saved:
      setattr(cls, name, self._wrap(name, fn))
    return self

  def __exit__(self, *exc):
    for cls, name, fn in self.saved:
      setattr(cls, name, fn)


def _rl_run(label, argv, writer, logs=True):
  """rl.main over argv with the launch counts set to 0 just before and
  read just after; every logged scalar finite (and, with `logs`, some
  logged), no kernel but the lcd raster launched. Returns (algo, wall s,
  launches)."""
  writer.scalars.clear()
  _zero_launches()
  t0 = time.perf_counter()
  algo = rl_main.main(argv)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _launches()
  bad = [(k, v) for k, v in writer.scalars if not np.isfinite(v)]
  log(f'[rl] {label}: {wall:.2f} s; launches {launches}; '
      f'{len(writer.scalars)} scalars logged, '
      f'{sorted({k for k, _ in writer.scalars})}')
  if (logs and not writer.scalars) or bad:
    raise RuntimeError(f'{label}: logged scalars {bad or "none"}')
  if launches != _expect(lcd_raster=launches['lcd_raster']) or \
      not launches['lcd_raster']:
    raise RuntimeError(f'{label}: launches {launches}')
  return algo, wall, launches


def _logged(writer, tag):
  return [v for k, v in writer.scalars if k == tag]


def _moved(net, target):
  """Whether SAC's parameters left their initial values: the target
  starts equal to the net and follows it by polyak averaging, so they
  differ only once the net moved."""
  return any(not torch.equal(p, q) for p, q in
             zip(net.parameters(), target.parameters()))


def _cpu_twin(algo, modules):
  """A shallow copy of an RL algo with `modules` deep-copied to the CPU."""
  twin = copy.copy(algo)
  twin.device = torch.device('cpu')
  for name in modules:
    setattr(twin, name, copy.deepcopy(getattr(algo, name)).cpu())
  return twin


def _opt_twin(opt, params):
  """Adam over `params` with a copy of `opt`'s learning rate and state."""
  new = adam(params, opt.param_groups[0]['lr'])
  new.load_state_dict(copy.deepcopy(opt.state_dict()))
  return new


def _tree(x, dev):
  if isinstance(x, dict):
    return {k: _tree(v, dev) for k, v in x.items()}
  return torch.as_tensor(np.asarray(x), device=dev)


def _max_diff(a, b):
  if isinstance(a, dict):
    return max(_max_diff(a[k], b[k]) for k in a)
  if isinstance(a, (tuple, list)):
    return max(_max_diff(x, y) for x, y in zip(a, b))
  return float((a.detach().cpu().double() - b.detach().cpu().double()
                ).abs().max())


def _rel_diff(a, b):
  a, b = float(a), float(b)
  return abs(a - b) / abs(b)


def _rl_card_vs_cpu(ppo, sac):
  """One PPO pi and v update, one SAC update (cnn) and their forwards on
  the card against CPU twins (same state dicts and optimizer states, same
  batch and normals), TF32 off; phase 12's gates: outputs and parameters
  within WM_LOGIT_TOL, losses within WM_LOSS_RTOL relative."""
  rng = np.random.RandomState(3)
  G, dev = ppo.G, ppo.device
  n = int(G.bs)
  out, losses = {}, {}
  # PPO: the batch's old logp sits 0.5 above the policy's, and its
  # advantages at mean 1. A relative gate on a mean of differences reads
  # the float32 rounding of its terms (logp ~ -10: ~1e-7) over the mean:
  # at advantages of mean 0 the loss, and at an offset of 0.05 the kl
  # (2.2e-6 relative in one run), were cancellations, not device
  # differences. At +0.5 the ratio, ~0.61, stays unclipped wherever the
  # advantage is positive (84% of rows), so the pi step keeps its gradient
  S = ppo.obs_space[G.state_key].shape[-1]
  obs = {k: rng.uniform(-1, 1, (n, S)).astype(np.float32)
         for k in (G.state_key, ppo.goal_key)}
  eps = rng.randn(n, ppo.act_space.shape[-1]).astype(np.float32)
  with torch.no_grad():
    mu, std = ppo.ac.policy(_tree(obs, dev))
    act = mu + std * _tree(eps, dev)
    logp = gaussian_logp(mu, std, act).cpu().numpy()
  batch = {'obs': obs, 'act': act.cpu().numpy(),
           'logp': (logp + 0.5 + 0.1 * rng.randn(n)).astype(np.float32),
           'adv': (1 + rng.randn(n)).astype(np.float32),
           'ret': rng.randn(n).astype(np.float32)}
  twin = _cpu_twin(ppo, ['ac'])
  twin.pi_opt = _opt_twin(ppo.pi_opt, twin.ac.pi.parameters())
  twin.v_opt = _opt_twin(ppo.v_opt, twin.ac.v.parameters())
  cb, tb = _tree(batch, dev), _tree(batch, 'cpu')
  with torch.no_grad():
    out['ppo_forward'] = _max_diff(ppo.ac(cb['obs']), twin.ac(tb['obs']))
  values = {}
  for name, a, b in zip(('pi', 'kl', 'entropy'), ppo._pi_update(cb),
                        twin._pi_update(tb)):
    losses[f'ppo_{name}'] = _rel_diff(a, b)
    values[f'ppo_{name}'] = float(b)
  a, b = ppo._v_update(cb), twin._v_update(tb)
  losses['ppo_v'], values['ppo_v'] = _rel_diff(a, b), float(b)
  out['ppo_params'] = _max_diff(ppo.ac.state_dict(), twin.ac.state_dict())
  # SAC, cnn: a replay batch and the normals of both actor draws
  sbatch = sac.buf.sample_batch(np.random.RandomState(4), int(sac.G.bs))
  A = sac.act_space.shape[-1]
  seps = [rng.randn(len(sbatch['rew']), A).astype(np.float32)
          for _ in range(2)]
  twin = _cpu_twin(sac, ['net', 'target'])
  twin.log_alpha = sac.log_alpha.detach().cpu().clone().requires_grad_(True)
  twin.pi_params = list(twin.net.pi.parameters())
  twin.q_params = [*twin.net.q1.parameters(), *twin.net.q2.parameters()]
  twin.pi_opt = _opt_twin(sac.pi_opt, twin.pi_params)
  twin.q_opt = _opt_twin(sac.q_opt, twin.q_params)
  twin.a_opt = _opt_twin(sac.a_opt, [twin.log_alpha])
  cb, tb = _tree(sbatch, dev), _tree(sbatch, 'cpu')
  with torch.no_grad():
    out['sac_forward'] = _max_diff(
        sac.net(cb['obs'], cb['act'], eps=_tree(seps[0], dev)),
        twin.net(tb['obs'], tb['act'], eps=_tree(seps[0], 'cpu')))
  cm = sac.update(cb, *[_tree(e, dev) for e in seps])
  tm = twin.update(tb, *[_tree(e, 'cpu') for e in seps])
  for k in ('loss/q', 'loss/pi', 'loss/alpha'):
    losses[f'sac_{k}'] = _rel_diff(cm[k], tm[k])
    values[f'sac_{k}'] = float(tm[k])
  out['sac_metrics'] = max(_max_diff(cm[k], tm[k]) for k in
                           ('q1', 'q2', 'alpha', 'logp'))
  out['sac_params'] = max(_max_diff(sac.net.state_dict(),
                                    twin.net.state_dict()),
                          _max_diff(sac.target.state_dict(),
                                    twin.target.state_dict()),
                          _max_diff(sac.log_alpha, twin.log_alpha))
  log(f'[rl] card vs CPU (float32 both, TF32 off, same state dicts, '
      f'optimizer states and batch; PPO {n} rows, SAC cnn '
      f'{len(sbatch["rew"])}): outputs and parameters {out}, losses '
      f'(relative) {losses} of the CPU\'s {values}; gates {WM_LOGIT_TOL} '
      f'abs, {WM_LOSS_RTOL} rel')
  if max(out.values()) > WM_LOGIT_TOL or max(losses.values()) > WM_LOSS_RTOL:
    raise RuntimeError(f'RL: card and CPU differ: {out} {losses}')
  return dict(out, losses=losses, values=values)


def rl_phase(dev, smi, tmp):
  """The RL chain on the card through research.rl.main and eval_policy,
  over phase 12's FBT (`tmp`/fbt): PPO in the learned env (the fused dream
  epoch, 2 headline epochs), PPO in the real env (the fused real epoch),
  eval_policy on the learned-env checkpoint, SAC's replay run (cnn) and
  firehose (the learned env, mlp), then card against CPU."""
  set_tf32(False)
  writer = ScalarWriter()
  saved_writer = research_utils.make_writer
  research_utils.make_writer = lambda logdir: writer
  saved_eval = eval_policy.ITERS, eval_policy.EVIDENCE_DIR
  eval_policy.ITERS, eval_policy.EVIDENCE_DIR = RL_EVAL_ITERS, tmp / 'evidence'
  out = {}
  try:
    # 1. PPO in the learned env: the epochs' rollouts and updates timed,
    # the mean actions kept when ppo.pkl is written; then RL_PROFILED_STEPS
    # more dream steps profiled
    ldir = tmp / 'ppo_lenv'
    kept = {}
    save = PPO.save

    def keep_save(self, direc, name='ppo.pkl'):
      if name == 'ppo.pkl':
        g = torch.Generator(device=dev).manual_seed(8)
        n = self.obs_space[self.G.state_key].shape[-1]
        kept['obs'] = {k: torch.rand((64, n), generator=g, device=dev) * 2 - 1
                       for k in (self.G.state_key, self.goal_key)}
        kept['a'] = self.get_a(kept['obs'], deterministic=True)
      return save(self, direc, name)
    PPO.save = keep_save
    try:
      with Timed([(PPO, 'lenv_rollout'), (PPO, 'update'),
                  (PPO, '_run_fused_lenv_epoch'), (RLAlgo, 'test_agent')]
                 ) as t:
        ppo, wall, launches = _rl_run(
            'PPO, learned env (FBT)', [*RL_COMMON, *RL_LENV,
                                       f'--weightdir={tmp / "fbt"}',
                                       f'--logdir={ldir}', 'ppo'], writer)
    finally:
      PPO.save = save
    roll, upd = t.calls['lenv_rollout'], t.calls['update']
    epochs = t.calls['_run_fused_lenv_epoch']
    steps = ppo.steps_per_epoch
    B = ppo.G.num_envs
    # an epoch as dt/epoch measures it: the rollout, the GAE buffer's fill
    # and the update
    epoch_s = [(e['ms'] + u['ms']) / 1e3 for e, u in zip(epochs, upd)]
    step_ms = [c['ms'] / steps for c in roll]
    dev_ms, events = profiled(
        lambda: ppo.lenv_rollout(*ppo._lenv_state, RL_PROFILED_STEPS), 1)
    dev_step = None if dev_ms is None else dev_ms / RL_PROFILED_STEPS
    busy = None if dev_step is None else dev_step / min(step_ms)
    pool = pool_size(B)
    log(f'[rl] PPO learned env: {len(epochs)} epochs of {steps} fused steps '
        f'x {B} envs; epoch s {epoch_s}; rollout '
        f'{[round(c["ms"], 1) for c in roll]} ms, {step_ms} ms a step, '
        f'{B * 1e3 / min(step_ms):.1f} learned env-steps/s; updates (80 pi '
        f'+ 80 v, bs {ppo.G.bs}) {[round(c["ms"], 1) for c in upd]} ms; '
        f'device {_fmt(dev_step)} a step in '
        f'{events / RL_PROFILED_STEPS:.0f} events ({RL_PROFILED_STEPS} '
        f'steps profiled), busy {busy} of the faster epoch\'s step; lcd '
        f'launches an epoch {[c["lcd"] for c in epochs]} (2 pools of {pool}; '
        f'the first epoch also resets: goals, prompts); real-env test '
        f'{[round(c["ms"]) for c in t.calls["test_agent"]]} ms on {smi}')
    if [c['lcd'] for c in epochs] != [4] + [2] * (len(epochs) - 1):
      raise RuntimeError(f'PPO learned env: lcd launches an epoch '
                         f'{[c["lcd"] for c in epochs]}')
    if len(epochs) != RL_LENV_EPOCHS or not (ldir / 'ppo.pkl').exists():
      raise RuntimeError(f'PPO learned env: epochs {epoch_s}, ppo.pkl '
                         f'{(ldir / "ppo.pkl").exists()}')
    ppo.load(ldir)
    again = ppo.get_a(kept['obs'], deterministic=True)
    if not torch.equal(again, kept['a']):
      raise RuntimeError('ppo.pkl reloaded gives other mean actions')
    log(f'[rl] ppo.pkl reloaded: the mean actions of {len(again)} test '
        f'observations bit for bit')
    out['ppo_lenv'] = dict(
        wall_s=wall, launches=launches, epoch_s=epoch_s,
        rollout_ms=[c['ms'] for c in roll], step_ms=step_ms,
        env_steps_per_s=B * 1e3 / min(step_ms),
        update_ms=[c['ms'] for c in upd], busy=busy,
        device_ms_a_step=dev_step, events_a_step=events / RL_PROFILED_STEPS,
        lcd_an_epoch=[c['lcd'] for c in epochs],
        test_ms=[c['ms'] for c in t.calls['test_agent']])

    # 2. PPO in the real env, the fused epoch
    with Timed([(PPO, 'rollout'), (PPO, 'update')]) as t:
      real, wall, launches = _rl_run(
          'PPO, real env', [*RL_COMMON, *RL_REAL,
                            f'--logdir={tmp / "ppo_real"}', 'ppo'], writer)
    (roll,) = t.calls['rollout']
    ms_step = roll['ms'] / RL_REAL_STEPS
    B = real.G.num_envs
    log(f'[rl] PPO real env: {RL_REAL_STEPS} fused steps x {B} envs in '
        f'{roll["ms"]:.1f} ms, {ms_step:.2f} ms a step, '
        f'{B * 1e3 / ms_step:.1f} env-steps/s; lcd launches '
        f'{roll["lcd"]} ({roll["lcd"] / RL_REAL_STEPS:.1f} a step); update '
        f'{t.calls["update"][0]["ms"]:.1f} ms on {smi}')
    if roll['lcd'] < RL_REAL_STEPS:
      raise RuntimeError(f'PPO real env: {roll["lcd"]} lcd launches in '
                         f'{RL_REAL_STEPS} steps')
    out['ppo_real'] = dict(wall_s=wall, launches=launches,
                           rollout_ms=roll['ms'], ms_a_step=ms_step,
                           lcd=roll['lcd'],
                           update_ms=t.calls['update'][0]['ms'])

    # 3. eval_policy on (1)'s checkpoint
    _zero_launches()
    t0 = time.perf_counter()
    rate = eval_policy.main([f'--logdir={ldir}', *RL_EVAL, 'ppo'])
    wall = time.perf_counter() - t0
    launches = _launches()
    evidence = sorted((tmp / 'evidence').glob('*.json'))
    with open(ldir / 'eval_policy.pkl', 'rb') as f:
      saved = pickle.load(f)
    ev = json.loads(evidence[0].read_text()) if evidence else {}
    log(f'[rl] eval_policy on the learned-env checkpoint: success '
        f'{rate} over {RL_EVAL_ITERS * eval_policy.N_ENVS} episodes in '
        f'{wall:.1f} s; launches {launches}; evidence {ev}')
    if not 0 <= rate <= 1 or saved != {'success_rate': rate} or \
        len(evidence) != 1 or ev.get('trained_in') != 'learned_sim' or \
        launches != _expect(lcd_raster=launches['lcd_raster']):
      raise RuntimeError(f'eval_policy: {rate} {saved} {evidence} {launches}')
    out['eval_policy'] = dict(success_rate=rate, wall_s=wall,
                              launches=launches, evidence=ev)

    # 4. SAC: the replay run (cnn, real env) and the firehose (learned env)
    with Timed([(SAC, 'update_burst')]) as t:
      sac, wall, launches = _rl_run(
          'SAC run, real env, cnn', [*RL_COMMON, *RL_SAC_RUN,
                                     f'--logdir={tmp / "sac"}', 'sac'],
          writer, logs=False)   # no test and no log before t = 4000
    (burst,) = t.calls['update_burst']
    n = int(sac.G.update_every)
    logged = {k: np.asarray(v, np.float64) for k, v in sac.logger.items()}
    log(f'[rl] SAC run: one burst of {n} updates (bs {sac.G.bs}) in '
        f'{burst["ms"]:.1f} ms, {burst["ms"] / n:.2f} ms an update; metrics '
        f'{ {k: float(v.mean()) for k, v in logged.items()} } on {smi}')
    if not _moved(sac.net, sac.target) or not all(
        np.isfinite(v).all() for v in logged.values()) or \
        'loss/q' not in logged:
      raise RuntimeError(f'SAC run: parameters did not move or metrics '
                         f'{logged}')
    with Timed([(SAC, 'update')]) as t:
      fire, wall, launches = _rl_run(
          'SAC firehose, learned env (FBT), mlp',
          [*RL_COMMON, *RL_SAC_FIRE, f'--weightdir={tmp / "fbt"}',
           f'--logdir={tmp / "sac_fire"}', 'sac'], writer)
    ms = [c['ms'] for c in t.calls['update']]
    log(f'[rl] SAC firehose: {len(ms)} updates on {fire.G.num_envs}-row '
        f'transition batches, {np.mean(ms[1:]):.2f} ms an update (after the '
        f'first, {ms[0]:.1f}); fps {_logged(writer, "fps")} on {smi}')
    if not _moved(fire.net, fire.target) or len(ms) != RL_FIRE_ITERS:
      raise RuntimeError('SAC firehose: parameters did not move')
    out['sac'] = dict(burst_ms=burst['ms'], ms_an_update=burst['ms'] / n,
                      firehose_update_ms=ms, firehose_launches=launches,
                      firehose_wall_s=wall)
    # 5. card against CPU
    out['card_vs_cpu'] = _rl_card_vs_cpu(ppo, sac)
  finally:
    research_utils.make_writer = saved_writer
    eval_policy.ITERS, eval_policy.EVIDENCE_DIR = saved_eval
  return out


# phase 16, visualisation: over phase 12's BVAE and FBT (Urchin, kicker.py's
# widths, window 50, prompt 3) through research.main's viz and fiddle modes
VIZ_ROLLOUTS = 1            # Vizer.run's n_rollouts, of the CLI's 4
VIZ_AUTOENV_STEPS = 3
VIZ_CPU_ITERS = 3           # optimize_actions' card-vs-CPU iterations (the
                            # path's 10 are timed on the card)
# card vs CPU, float32, TF32 off: optimize_actions' losses and planned
# actions, the Fiddler's sensitivities (where no code of the batch sits
# within LENV_MARGIN of its threshold), within VIZ_TOL; MiniGPT's loss after
# one Adam step within WM_LOSS_RTOL relative
VIZ_TOL = 2e-4
# the scripts and examples: at bench.py's 8/4 solver iterations (their
# default 180/60 is 20x the solver launches of a plain step, each step
# seconds on the card) and the smallest depths that exercise each;
# lcd_wave's 12 steps reach its wipe (the LCD enters at step 11)
VIZ_DEMO = ['--envs=Bounce', '--steps=1']
VIZ_WAVE = ['--env=Bounce', '--steps=12']
VIZ_GOAL = ['--env=Urchin', '--rows=1', '--cols=2', '--vel_iters=8',
            '--pos_iters=4']
VIZ_SAMPLE = ['--env=Urchin', '--model=FBT', '--frames=8']
VIZ_BASIC = ['--steps=1']             # prints t = 0 (of 0, 10, ... 40)
VIZ_LESS_BASIC = ['--env=Bounce', '--steps=2', '--headless=1']
VIZ_COLLECT = ['--num_eps=8', '--batch=8', '--ep_len=5']
VIZ_TRAIN_WINDOW = 5                  # train.py's widths, its window cut
VIZ_TRAIN = ['--epochs=1', '--bs=4', f'--window={VIZ_TRAIN_WINDOW}']


def _decodes(path):
  """The frames of a written gif or PNG as (frames, H, W, 3) uint8, or of
  its npz stand-in."""
  path = str(path)
  if path.endswith('.npz'):
    return np.load(path)['frames']
  from PIL import Image
  with Image.open(path) as im:
    frames = []
    for i in range(getattr(im, 'n_frames', 1)):
      im.seek(i)
      frames.append(np.asarray(im.convert('RGB')))
  return np.stack(frames)


def _as_gif(frames):
  """What a gif keeps of a sequence of frames: Pillow merges a frame equal
  to the one before it into that one's duration."""
  keep = [0] + [i for i in range(1, len(frames))
                if not np.array_equal(frames[i], frames[i - 1])]
  return frames[keep]


class StepRecorder:
  """Keeps the states `Env.step` returns while the context lasts: the truth
  rollouts' states, re-rendered by the plain raster afterwards."""

  def __enter__(self):
    self.states = []
    self.saved = Env.step

    def step(env, state, action):
      out = self.saved(env, state, action)
      self.states.append(out[0])
      return out
    Env.step = step
    return self

  def __exit__(self, *exc):
    Env.step = self.saved


def _plain_frames(env, states):
  """The plain raster's frames of a list of batch-of-one states."""
  ic, c, a = (torch.cat(x) for x in zip(*[(s.is_circle, s.c, s.a)
                                          for s in states]))
  return raster.lcd_render_plain(env.spec, ic, c, torch.cos(a), torch.sin(a),
                                  env.lcd_w, env.lcd_h)


def _viz_run(label, argv, smi):
  """research.main's viz mode over argv at VIZ_ROLLOUTS rollouts, the
  launch counts set to 0 just before and read just after: one lcd raster
  launch a truth step and no other kernel; the gifs decode to the
  rollouts' frames, the truth frames equal the plain raster's frames of
  the stepped states, bit for bit. Returns (runner, record, measures)."""
  G, env = research_main.parse_flags(['--mode=viz', *argv])
  _zero_launches()
  targets = [(vizer, 'truth_rollout'), (vizer.Vizer, 'optimize_actions')]
  with StepRecorder() as rec, Timed(targets) as t:
    t0 = time.perf_counter()
    runner, recs = research_main.visualize(G, env, n_rollouts=VIZ_ROLLOUTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  launches = _launches()
  T, H = runner.model.block_size, env.lcd_h
  steps = VIZ_ROLLOUTS * T
  truth = np.concatenate([r['truth'] for r in recs])
  plain = _plain_frames(env, rec.states).float().cpu().numpy()
  truth_ms = [c['ms'] / T for c in t.calls['truth_rollout']]
  opt = [c['ms'] / 10 for c in t.calls['optimize_actions']]
  log(f'[viz] {label}: {type(runner).__name__}, {len(recs)} rollout(s) of '
      f'{T} truth steps in {wall:.2f} s; {truth_ms} ms a truth step (lcd '
      f'launches {[c["lcd"] for c in t.calls["truth_rollout"]]}); '
      f'optimize_actions {opt} ms an iteration (10 a plan); losses '
      f'{[(r.get("loss0"), r.get("loss1")) for r in recs]}; launches '
      f'{launches} on {smi}')
  if launches != _expect(lcd_raster=steps) or len(rec.states) != steps:
    raise RuntimeError(f'{label}: launches {launches}, {len(rec.states)} '
                       f'stepped states for {steps} truth steps')
  if not np.array_equal(truth, plain):
    raise RuntimeError(f'{label}: truth frames differ from the plain raster '
                       f'in {int((truth != plain).sum())} pixels')
  for r in recs:
    frames = _decodes(r['gif'])[..., 0]
    strip = np.concatenate([r['truth'], r['sample']], 1)
    if not np.array_equal(frames, _as_gif((255 * strip).astype(np.uint8))):
      raise RuntimeError(f'{label}: {r["gif"]} decodes to {frames.shape}, '
                         f'not the truth over the sample')
    if G.optimize_actions:
      a = r['actions']
      strip = np.concatenate([r['before'], r['after']], 1)
      if not np.array_equal(_decodes(r['opt_gif'])[..., 0], _as_gif(
          (255 * strip).astype(np.uint8))) or not np.isfinite(
          [r['loss0'], r['loss1']]).all() or float(a.abs().max()) > 1 or \
          a.shape != (1, T, env.act_size):
        raise RuntimeError(f'{label}: the plan {r["loss0"]} -> '
                           f'{r["loss1"]}, actions {tuple(a.shape)}')
  return runner, recs, dict(wall_s=wall, launches=launches,
                            truth_ms_a_step=truth_ms,
                            optimize_ms_an_iteration=opt,
                            losses=[(r.get('loss0'), r.get('loss1'))
                                    for r in recs])


def _twin(model, cpu_env):
  """The CPU copy of a BVAE or an FBT (with its BVAE): the same state
  dicts."""
  G = AttrDict(model.G, device='cpu')
  if model.name == 'BVAE':
    twin = BVAE(cpu_env, G)
  else:
    twin = FBT(cpu_env, G, bvae=_twin(model.bvae, cpu_env))
  twin.module.load_state_dict(model.module.state_dict())
  return twin


def _opt_card_vs_cpu(fbt, data):
  """optimize_actions for VIZ_CPU_ITERS iterations on the card and on the
  CPU, from one test episode's prompts and actions toward its last frame,
  with the same sampler uniforms: the losses and the planned actions."""
  cpu = _twin(fbt, _env(MAIN_ENV, 'cpu'))
  batch = next(RolloutDataset(data / 'test', window=fbt.block_size)
               .batches(1))
  g = torch.Generator().manual_seed(3)
  u = [torch.rand((fbt.block_size, 1, fbt.z_size), generator=g)
       for _ in range(VIZ_CPU_ITERS)]
  out = {}
  for name, m in (('card', fbt), ('cpu', cpu)):
    dev = m.device
    prompts = {k: torch.as_tensor(batch[k], device=dev)
               for k in ('lcd', 'proprio')}
    out[name] = vizer.Vizer(m, m.env, m.G).optimize_actions(
        None, batch['action'], prompts, batch['lcd'][0, -1],
        iters=VIZ_CPU_ITERS, u=[x.to(dev) for x in u])
  (ca, c0, c1), (pa, p0, p1) = out['card'], out['cpu']
  return dict(loss_err=max(abs(c0 - p0), abs(c1 - p1)),
              actions_err=float((ca.cpu() - pa).abs().max()),
              losses=(c0, c1), moved=float((pa - torch.as_tensor(
                  batch['action'])).abs().max()))


def _fiddle_card_vs_cpu(bvae, G, tmp):
  """The Fiddler on the card and on the CPU over one test batch and the
  same normals: sensitivities within VIZ_TOL wherever no code of the
  batch's encodes (base or perturbed) sits within LENV_MARGIN of its
  threshold on the CPU, and no code apart beyond that margin."""
  cpu = _twin(bvae, _env(MAIN_ENV, 'cpu'))
  batch = next(RolloutDataset(Path(G.datadir) / 'test', window=G.window)
               .batches(G.bs))
  flat = {k: torch.as_tensor(v.reshape(-1, *v.shape[2:]))
          for k, v in batch.items() if k != 'action'}
  N, P = flat['proprio'].shape
  noise = torch.randn((P, N), generator=torch.Generator().manual_seed(5))
  saved = fiddler.load_ds
  fiddler.load_ds = lambda G: (None, [batch])
  sens, apart, near = {}, 0, torch.zeros((P, bvae.z_size), dtype=torch.bool)
  try:
    for name, m in (('card', bvae), ('cpu', cpu)):
      fG = AttrDict(G, logdir=str(tmp / f'fiddle_{name}'))
      fiddler.Fiddler(m, m.env, fG).run(noise=noise)
      with open(tmp / f'fiddle_{name}' / 'vec_weights.pkl', 'rb') as f:
        sens[name] = pickle.load(f)['sensitivity']
  finally:
    fiddler.load_ds = saved
  with torch.no_grad():
    for d in [None, *range(P)]:
      pert = dict(flat)
      if d is not None:
        pert['proprio'] = flat['proprio'].clone()
        pert['proprio'][:, d] += 0.2 * noise[d]
      p = torch.sigmoid(cpu.module.enc(pert['lcd'], pert['proprio'])
                        ).reshape(N, -1)
      edge = ((p - 0.5).abs() <= LENV_MARGIN)
      codes = {name: m.encode({k: v.to(m.device) for k, v in pert.items()},
                              noise=False).cpu() > 0.5
               for name, m in (('card', bvae), ('cpu', cpu))}
      apart += int(((codes['card'] != codes['cpu']) & ~edge).sum())
      if d is None:
        near |= edge.any(0)[None]
      else:
        near[d] |= edge.any(0)
  diff = np.abs(sens['card'] - sens['cpu'])
  return dict(sens_err=float(diff[~near.numpy()].max(initial=0.0)),
              sens_err_all=float(diff.max()), codes_apart_beyond=apart,
              cells_near_threshold=int(near.sum()), cells=int(near.numel()))


def _minigpt_card_vs_cpu(npz, dev):
  """MiniGPT at train.py's widths on the card and on the CPU (the same
  init), one Adam step on the same batch of the collected episodes: the
  losses before and after within WM_LOSS_RTOL relative."""
  data = np.load(npz)
  W = VIZ_TRAIN_WINDOW
  batch = {'lcd': data['lcd'][:4, :W].astype(np.float32),
           'action': data['action'][:4, :W]}
  G = AttrDict(n_embed=128, n_head=4, n_layer=2, window=W, lr=5e-4)
  out = {}
  for name, d in (('card', dev), ('cpu', 'cpu')):
    m = ex_model.Model(_env('Bounce', d), G)
    first = m.train_step(batch)['loss']
    with torch.no_grad():
      after = float(m.loss_fn({k: torch.as_tensor(v, device=m.device)
                               for k, v in batch.items()})[0])
    out[name] = (first, after)
  rel = max(abs(a - b) / abs(b) for a, b in zip(out['card'], out['cpu']))
  return dict(loss_rel_err=rel, losses=out)


def _timed_call(label, fn, argv, smi, lcd):
  """fn(argv) with the launch counts set to 0 just before and read just
  after: `lcd` lcd raster launches and no other kernel. Returns (result,
  s, launches)."""
  _zero_launches()
  t0 = time.perf_counter()
  out = fn(argv)
  torch.cuda.synchronize()
  s = time.perf_counter() - t0
  launches = _launches()
  log(f'[viz] {label} {" ".join(argv)}: {s:.2f} s; launches {launches} on '
      f'{smi}')
  if launches != _expect(lcd_raster=lcd):
    raise RuntimeError(f'{label}: launches {launches}, not {lcd} lcd')
  return out, s, launches


def _scripts_and_examples(dev, smi, tmp):
  """The four media scripts and the five examples at the smallest depths
  that exercise each, solver iterations 8/4; every file decodes."""
  out = {}
  saved = engine_spec.DEFAULT_ITERS
  engine_spec.DEFAULT_ITERS = (ITERS['vel_iters'], ITERS['pos_iters'])
  try:
    paths, s, _ = _timed_call('demo_gifs', demo_gifs.main,
                              [*VIZ_DEMO, f'--outdir={tmp / "demos"}'], smi,
                              lcd=1)
    frames = _decodes(paths['Bounce'])
    if frames.shape != (1, 128, 128, 3):
      raise RuntimeError(f'demo_gifs: {frames.shape}')
    out['demo_gifs_s'] = s
    path, s, _ = _timed_call('lcd_wave', lcd_wave.main,
                             [*VIZ_WAVE, f'--outdir={tmp / "figs"}'], smi,
                             lcd=13)           # 12 steps + the batched render
    frames = _decodes(path)
    if not 1 <= len(frames) <= 12 or frames.shape[1:] != (256, 258, 3) or \
        not frames.std() > 0:
      raise RuntimeError(f'lcd_wave: {frames.shape}')
    out['lcd_wave_s'] = s
    path, s, _ = _timed_call('viz_goal', viz_goal.main,
                             [*VIZ_GOAL, f'--outdir={tmp / "figs"}'], smi,
                             lcd=4)            # 2 resets of goal + state
    img = _decodes(path)[0].astype(int)
    if img.shape != (128, 520, 3) or not (img[..., 0] > img[..., 1] + 64
                                          ).any():
      raise RuntimeError(f'viz_goal: {img.shape}, no red goal')
    out['viz_goal_s'] = s
    (path, truth, pred), s, _ = _timed_call(
        'sample_model', sample_model.main,
        [*VIZ_SAMPLE, f'--weightdir={tmp / "fbt"}',
         f'--outdir={tmp / "figs"}'], smi,
        lcd=int(Net.load_config(tmp / "fbt", "FBT").window))
    img = _decodes(path)[0]
    H, W = truth.shape[1:]
    if img.shape != ((3 * H + 2) * 8, (8 * W + 7) * 8, 3) or not \
        np.array_equal(img, (255 * sample_model.frame_strip(
            truth, pred, 1, 8)).astype(np.uint8)):
      raise RuntimeError(f'sample_model: {img.shape}')
    out['sample_model_s'] = s
    printed, s, _ = _timed_call('examples.basic', ex_basic.main,
                                VIZ_BASIC, smi, lcd=2)
    if sorted(printed) != [0] or printed[0].all() or not printed[0].any():
      raise RuntimeError(f'basic printed {sorted(printed)}')
    out['basic_s'] = s
    path, s, _ = _timed_call('examples.less_basic', ex_less_basic.main,
                             [*VIZ_LESS_BASIC, f'--out={tmp / "lb.gif"}'],
                             smi, lcd=3)
    frames = _decodes(path)
    if not 1 <= len(frames) <= 2 or frames.shape[1:] != (128, 128, 3):
      raise RuntimeError(f'less_basic: {frames.shape}')
    out['less_basic_s'] = s
    npz = tmp / 'rollouts.npz'
    traj, s, _ = _timed_call('examples.collect', ex_collect.main,
                             [*VIZ_COLLECT, f'--out={npz}'], smi, lcd=5)
    if traj['lcd'].shape != (8, 5, 16, 16):
      raise RuntimeError(f'collect: lcd {traj["lcd"].shape}')
    out['collect_s'] = s
    (model, bpd, samp), s, _ = _timed_call(
        'examples.train', ex_train.main, [*VIZ_TRAIN, f'--data={npz}'], smi,
        lcd=0)
    if not np.isfinite(bpd).all() or \
        tuple(samp.shape) != (4, VIZ_TRAIN_WINDOW, 256):
      raise RuntimeError(f'train: bits/dim {bpd}, sample {samp.shape}')
    out['train_s'] = s
    out['train_bits_per_dim'] = bpd
    out['minigpt_card_vs_cpu'] = _minigpt_card_vs_cpu(npz, dev)
  finally:
    engine_spec.DEFAULT_ITERS = saved
  return out


def viz_phase(dev, smi, tmp):
  """The visualisation chain on the card over phase 12's BVAE and FBT
  (`tmp`/bvae, `tmp`/fbt, `tmp`/data): --mode=viz with optimize_actions,
  --mode=viz --interactive=1 (the headless fallback), --mode=fiddle,
  ipython_mode, AutoEnv, render('human'), the media scripts and the
  examples; then card against CPU."""
  set_tf32(False)
  out = {}
  common = [f'--weightdir={tmp / "fbt"}', '--model=FBT', *WM_COMMON]
  runner, recs, out['viz'] = _viz_run(
      'research.main --mode=viz --optimize_actions=1',
      [*common, f'--logdir={tmp / "viz"}', '--optimize_actions=1'], smi)
  irunner, _, out['viz_interactive'] = _viz_run(
      'research.main --mode=viz --interactive=1',
      [*common, f'--logdir={tmp / "viz_i"}', '--interactive=1'], smi)
  if irunner.have_window:
    raise RuntimeError('a pyglet window opened on the card host')
  log('[viz] --interactive=1: no pyglet window here, the headless replay '
      'ran (pyglet '
      f'{"installed" if viewer.HAVE_PYGLET else "not installed"})')

  # AutoEnv: prime 9 real frames, then VIZ_AUTOENV_STEPS lockstep steps;
  # its G is the model's (the window AutoEnv slides is G.window: the CLI's
  # G holds the default 200 where the weightdir has no hps.yaml, as a
  # device-dataset run leaves it)
  model, env, G = runner.model, runner.env, runner.model.G
  np.random.seed(0)
  _zero_launches()
  ae = vizer.AutoEnv(model, env, G)
  t0 = time.perf_counter()
  truth, pred, goal = ae.reset()
  count0 = ae.count
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t0
  step_ms = []
  for _ in range(VIZ_AUTOENV_STEPS):
    t0 = time.perf_counter()
    truth, pred, rew, lrew, goal = ae.step(env.action_space.sample())
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
  launches = _launches()
  primed = min(9, G.window - 2)
  log(f'[viz] AutoEnv: primed {primed} real frames in {reset_s:.2f} s, '
      f'{VIZ_AUTOENV_STEPS} lockstep steps {step_ms} ms (a truth step and '
      f'an FBT onestep over the {G.window}-frame window); pointer {count0} '
      f'-> {ae.count}; launches {launches} on {smi}')
  want = (env.lcd_h * 8, env.lcd_w * 8, 3)
  if launches != _expect(lcd_raster=1 + primed + VIZ_AUTOENV_STEPS) or \
      truth.shape != want or pred.shape != want or \
      ae.count != min(count0 + VIZ_AUTOENV_STEPS, G.window - 2) or \
      not np.isfinite(ae.window_batch['proprio']).all():
    raise RuntimeError(f'AutoEnv: launches {launches}, frames {truth.shape}'
                       f' {pred.shape}, pointer {ae.count}')
  out['autoenv'] = dict(reset_s=reset_s, step_ms=step_ms, launches=launches)

  # render('human') on the AutoEnv's state, into the ArrayViewer
  _zero_launches()
  img = env.render('human')
  st = env.state
  lcd = raster.lcd_render_plain(env.spec, st.is_circle, st.c,
                                torch.cos(st.a), torch.sin(st.a), env.lcd_w,
                                env.lcd_h)[0].cpu().numpy()
  W8 = env.lcd_w * 8
  if img.shape != (env.lcd_h * 8, 2 * W8 + 1, 3) or not np.array_equal(
      img[:, W8 + 1:, 0], (255 * lcd.astype(np.uint8)).repeat(8, 0)
      .repeat(8, 1)) or not isinstance(env.viewer, viewer.ArrayViewer) or \
      _launches() != _expect(lcd_raster=1):
    raise RuntimeError(f'render(human): {img.shape}, {type(env.viewer)}, '
                       f'{_launches()}')
  log(f"[viz] render('human'): {img.shape} into an ArrayViewer, its LCD "
      f'half the plain raster\'s frame upscaled, bit for bit')

  # --mode=fiddle over phase 12's BVAE
  fG, fenv = research_main.parse_flags([
      '--mode=fiddle', '--model=BVAE', f'--weightdir={tmp / "bvae"}',
      f'--datadir={tmp / "data"}', f'--logdir={tmp / "fiddle"}',
      *WM_COMMON])
  _zero_launches()
  t0 = time.perf_counter()
  weights = research_main.fiddle(fG, fenv)
  torch.cuda.synchronize()
  fiddle_s = time.perf_counter() - t0
  with open(tmp / 'fiddle' / 'vec_weights.pkl', 'rb') as f:
    saved = pickle.load(f)
  sens = saved['sensitivity']
  log(f'[viz] research.main --mode=fiddle: {fiddle_s:.2f} s ({fG.bs} x '
      f'{fG.window} frames, {sens.shape[0]} proprio dims x {sens.shape[1]} '
      f'codes); launches {_launches()} on {smi}')
  if sens.shape != weights.shape or not np.isfinite(sens).all() or \
      not sens.any() or _launches() != _expect():
    raise RuntimeError(f'fiddle: {sens.shape}, {_launches()}')
  out['fiddle'] = dict(s=fiddle_s, shape=sens.shape)

  # ipython_mode, IPython.embed stood in (a smoke opens no REPL)
  have_ipython = importlib.util.find_spec('IPython') is not None
  seen = {}
  stub = types.ModuleType('IPython')
  stub.embed = lambda **kw: seen.update(sys._getframe(1).f_locals)
  saved_mod = sys.modules.get('IPython')
  sys.modules['IPython'] = stub
  try:
    research_main.main(['--ipython_mode=1', *common])
  finally:
    if saved_mod is None:
      sys.modules.pop('IPython')
    else:
      sys.modules['IPython'] = saved_mod
  m = seen.get('model')
  if m is None or m.device.type != dev.type or 'env' not in seen:
    raise RuntimeError(f'ipython_mode: {sorted(seen)}')
  installed = 'installed' if have_ipython else 'not installed'
  log(f'[viz] ipython_mode: env, G and the FBT (on {m.device}) in the '
      f"REPL's scope; IPython {installed} on this host, embed stood in")

  out['scripts'] = _scripts_and_examples(dev, smi, tmp)

  # card against CPU
  out['optimize_card_vs_cpu'] = o = _opt_card_vs_cpu(model, tmp / 'data')
  out['fiddle_card_vs_cpu'] = f = _fiddle_card_vs_cpu(model.bvae, fG, tmp)
  mg = out['scripts']['minigpt_card_vs_cpu']
  log(f'[viz] card vs CPU (float32, TF32 off): optimize_actions '
      f'({VIZ_CPU_ITERS} iterations) {o}; Fiddler {f}; MiniGPT one Adam '
      f'step {mg}; gates {VIZ_TOL}, {VIZ_TOL}, {WM_LOSS_RTOL} rel')
  if not (o['loss_err'] <= VIZ_TOL and o['actions_err'] <= VIZ_TOL and
          o['moved'] > 0 and f['sens_err'] <= VIZ_TOL and
          not f['codes_apart_beyond'] and
          mg['loss_rel_err'] <= WM_LOSS_RTOL):
    raise RuntimeError(f'viz card vs CPU: {o} {f} {mg}')
  return out


# phase 17, the entry points: --mesh=dpN at N = the card count through
# research.main (collect, train) and research.rl.main (PPO's fused real and
# learned-env epochs), each against the same run without --mesh, and
# --mesh=dp{N+1} raising; graft_entry; the port's bench.py lines
ENTRY_COLLECT = ['--env=Urchin', '--vel_iters=8', '--pos_iters=4',
                 f'--ep_len={PER_STEP_T}', '--train_barrels=1',
                 '--test_barrels=0', f'--num_envs={BARREL_SIZE}',
                 '--barrel_format=native']     # phase 9's depth, one barrel
ENTRY_TRAIN = ['--model=BVAE', '--total_itr=5', '--log_n=5', '--window=5']
# PPO at phase 15's widths; the real test's ep_len cut to 3 (each real-env
# test step is a plain step of 8 worlds, 0.6-0.9 s)
ENTRY_PPO_REAL = ['--lenv=0', '--steps_per_epoch=256', '--total_steps=256',
                  '--ep_len=3']
ENTRY_PPO_LENV = ['--lenv=1', '--model=FBT', '--steps_per_epoch=1280',
                  '--total_steps=1280', '--lenv_test=0', '--ep_len=3']
ENTRY_BENCH_SHORT = {'BENCH_STEPS': '2', 'BENCH_PIPELINE': '1',
                     'BENCH_MEGA_SMOKE': '0'}   # the sub and jnp lines


def _mesh_raises(label, fn, n):
  """fn must raise JAX's assertion for a mesh of n devices on n - 1."""
  want = f'mesh dp{n} needs {n} devices, have {n - 1}'
  try:
    fn()
  except AssertionError as e:
    if str(e) != want:
      raise RuntimeError(f'{label} --mesh=dp{n}: {e!r}, not {want!r}')
    log(f'[entry] {label} --mesh=dp{n} raises: {e}')
    return
  raise RuntimeError(f'{label} --mesh=dp{n} ran on {n - 1} cards')


def _entry_collect(tmp, N):
  """research.main --mode=collect --mesh=dpN against the unsharded
  per-step path (fill_barrels with collect_mega=0, as the CLI's collect
  calls it: the same flags and seed)."""
  out, bars = {}, {}
  for name in ('mesh', 'plain'):
    folder = tmp / 'entry_collect' / name
    _zero_launches()
    t0 = time.perf_counter()
    if name == 'mesh':
      research_main.main(['--mode=collect', f'--logdir={folder}',
                          *ENTRY_COLLECT, f'--mesh=dp{N}'])
    else:
      G, env = research_main.parse_flags(['--mode=collect',
                                          f'--logdir={folder}',
                                          *ENTRY_COLLECT])
      G.collect_mega = 0
      fill_barrels(env, int(G.train_barrels), 'train', G, torch.Generator(
          device=env.device).manual_seed(int(G.seed)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    (f,) = sorted((folder / 'train').glob('*.tbarrel.npz'))
    bars[name] = RolloutDataset(folder / 'train', infinite=False)._load(f)
    log(f'[entry] collect, {name} ({BARREL_SIZE} x {PER_STEP_T}, native): '
        f'{wall:.2f} s, '
        f'{BARREL_SIZE * PER_STEP_T / wall:.1f} env-steps/s; launches '
        f'{launches}')
    # the per-step path on every shard: one lcd raster launch a step
    if launches != _expect(lcd_raster=(N if name == 'mesh' else 1)
                           * PER_STEP_T):
      raise RuntimeError(f'collect {name}: launches {launches}')
    out[name] = dict(wall_s=wall, launches=launches,
                     env_steps_per_s=BARREL_SIZE * PER_STEP_T / wall)
  a, b = bars['mesh'], bars['plain']
  if set(a) != set(b):
    raise RuntimeError(f'collect barrels: keys {sorted(a)} vs {sorted(b)}')
  err = {}
  for k in b:
    if a[k].dtype.kind == 'f':
      err[k] = float(np.abs(a[k] - b[k]).max())
      if err[k] > 3e-7:          # tests/test_multichip.py's float slack
        raise RuntimeError(f'collect --mesh: {k} {err[k]:.3e} apart')
    elif not np.array_equal(a[k], b[k]):
      raise RuntimeError(f'collect --mesh: {k} not bit for bit')
  if b['lcd'].all() or not b['lcd'].any():
    raise RuntimeError('collect --mesh: blank frames')
  log(f'[entry] collect --mesh=dp{N} against unsharded: lcd and action '
      f'bit for bit, floats {err}')
  out['float_err'] = err
  _mesh_raises('research.main --mode=collect', lambda: research_main.main(
      ['--mode=collect', f'--logdir={tmp / "entry_collect" / "x"}',
       *ENTRY_COLLECT, f'--mesh=dp{N + 1}']), N + 1)
  return out


def _entry_train(tmp, N):
  out, hist = {}, {}
  data = tmp / 'data'
  for name, extra in (('mesh', [f'--mesh=dp{N}']), ('plain', [])):
    _zero_launches()
    model, hist[name], wall = _wm_train([
        f'--datadir={data}', f'--logdir={tmp / "entry_train" / name}',
        *WM_COMMON, *WM_BVAE, *ENTRY_TRAIN, *extra])
    if (model.mesh is None) != (name == 'plain') or \
        (model.mesh is not None and model.mesh.n != N):
      raise RuntimeError(f'train {name}: mesh {model.mesh}')
    log(f'[entry] research.main --mode=train BVAE {" ".join(extra)}: '
        f'{wall:.2f} s ({ENTRY_TRAIN[1]}); mesh {model.mesh}; launches '
        f'{_launches()}')
    out[name] = dict(wall_s=wall)
  rel = {}
  for (i, a), (j, b) in zip(hist['mesh'], hist['plain']):
    for k in b:
      if 'loss' in k:
        r = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
        rel[f'{i}:{k}'] = r
        if i != j or not math.isfinite(a[k]) or r > WM_LOSS_RTOL:
          raise RuntimeError(f'train --mesh: {k} at {i}: {a[k]} vs {b[k]}')
  if not rel:
    raise RuntimeError('train --mesh: no losses logged')
  log(f'[entry] train --mesh=dp{N} against unsharded: losses within '
      f'{max(rel.values()):.3e} rel (gate {WM_LOSS_RTOL})')
  out['loss_rel'] = max(rel.values())
  _mesh_raises('research.main --mode=train', lambda: research_main.main(
      ['--mode=train', f'--datadir={data}',
       f'--logdir={tmp / "entry_train" / "x"}', *WM_COMMON, *WM_BVAE,
       *ENTRY_TRAIN, f'--mesh=dp{N + 1}']), N + 1)
  return out


def _dream_parting(a, b, tol=1e-6):
  """Over N > 1 cards, per env of two dream epochs' GAE buffers (mesh,
  unsharded): the first step at which its reward or observation differ
  beyond tol. Each shard's FBT and BVAE run at their own batch size, so
  their products round differently (~1e-6); a token draw whose uniform
  sits that close to its probability flips, and that env's dream parts
  from there on. Returns ({env: first step}, the largest difference of
  any field before each env's parting, with adv/ret (sums over the
  future) only for envs that never part)."""
  T, B = a.rew.shape
  fields = {f: np.abs(getattr(a, f) - getattr(b, f)).reshape(T, B, -1)
            .max(-1) for f in ('act', 'rew', 'val', 'logp', 'adv', 'ret')}
  for k in b.obs:
    fields[f'obs:{k}'] = np.abs(a.obs[k] - b.obs[k]).reshape(T, B, -1).max(-1)
  parts = np.maximum(fields['rew'], *(v for k, v in fields.items()
                                      if k.startswith('obs:'))) > tol
  parted = {int(i): int(np.argmax(parts[:, i])) for i in range(B)
            if parts[:, i].any()}
  worst = 0.0
  for f, d in fields.items():
    for i in range(B):
      if i not in parted:
        worst = max(worst, float(d[:, i].max()))
      elif f not in ('adv', 'ret') and parted[i]:
        worst = max(worst, float(d[:parted[i], i].max()))
  return parted, worst


def _entry_ppo(tmp, N, writer):
  out = {}
  for kind, argv in (('real', ENTRY_PPO_REAL),
                     ('lenv', [*ENTRY_PPO_LENV,
                               f'--weightdir={tmp / "fbt"}'])):
    algos, losses = {}, {}
    for name, extra in (('mesh', [f'--mesh=dp{N}']), ('plain', [])):
      algos[name], wall, launches = _rl_run(
          f'PPO {kind} {" ".join(extra)}',
          [*RL_COMMON, *argv, *extra,
           f'--logdir={tmp / "entry_ppo" / kind / name}', 'ppo'], writer)
      losses[name] = {k: _logged(writer, k) for k in ('loss/pi', 'loss/v')}
      out[f'{kind}_{name}'] = dict(wall_s=wall, launches=launches)
    a, b = algos['mesh'].buf, algos['plain'].buf
    errs = {k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
            for k in ('act', 'rew', 'val', 'logp', 'adv', 'ret')}
    errs.update({f'obs:{k}': float(np.abs(a.obs[k] - b.obs[k]).max())
                 for k in b.obs})
    parted = {}
    if max(errs.values()) > 1e-6:
      if N == 1 or kind != 'lenv':
        raise RuntimeError(f'PPO {kind} --mesh: buffers apart {errs}')
      # over several cards a dream env may part at a token draw (see
      # _dream_parting); every other env, and each parted one up to its
      # parting, must still agree, and few may part
      parted, worst = _dream_parting(a, b)
      log(f'[entry] PPO lenv --mesh=dp{N}: {len(parted)} of {a.B} dream '
          f'envs part at steps {parted}; before that and elsewhere within '
          f'{worst:.3e} (all fields: {errs})')
      if worst > 1e-6 or len(parted) > a.B // 10:
        raise RuntimeError(f'PPO lenv --mesh: buffers apart {errs}, parted '
                           f'envs {parted}, {worst:.3e} elsewhere')
    if not parted:   # the update mixes every env's samples
      for k in ('loss/pi', 'loss/v'):
        x, y = losses['mesh'][k], losses['plain'][k]
        if not y or len(x) != len(y) or any(
            abs(p - q) > WM_LOSS_RTOL * abs(q) for p, q in zip(x, y)):
          raise RuntimeError(f'PPO {kind} --mesh: {k} {x} vs {y}')
    if kind == 'lenv':
      wa, wb = algos['mesh']._lenv_state[0], algos['plain']._lenv_state[0]
      keep = [i for i in range(a.B) if i not in parted]
      if not torch.equal(wa['lcd'][keep], wb['lcd'][keep]):
        raise RuntimeError('PPO lenv --mesh: dream frames differ')
    log(f'[entry] PPO {kind} epoch --mesh=dp{N} against unsharded: buffers '
        f'within {max(errs.values()):.3e}'
        + (f', losses within {WM_LOSS_RTOL} rel' if not parted else
           f'; {len(parted)} parted envs')
        + (', dream lcd bit for bit' if kind == 'lenv' else '')
        + (' (the others)' if parted else ''))
    out[f'{kind}_buffer_err'] = max(errs.values())
    out[f'{kind}_parted'] = parted
  _mesh_raises('research.rl.main ppo', lambda: rl_main.main(
      [*RL_COMMON, *ENTRY_PPO_REAL, f'--logdir={tmp / "entry_ppo" / "x"}',
       f'--mesh=dp{N + 1}', 'ppo']), N + 1)
  return out


def _entry_bench(smi):
  """The port's bench.py lines, each with every launch count set to 0 just
  before and read just after."""
  from boxlcd_tpu_torch import bench
  out = {}
  lines = (('auto', {}, 3), ('sub', {'BENCH_SOLVER': 'sub',
                                     **ENTRY_BENCH_SHORT}, 1),
           ('jnp', {'BENCH_SOLVER': 'jnp', **ENTRY_BENCH_SHORT}, 1))
  for name, env, iters in lines:
    with mock.patch.dict(os.environ):   # restored on exit
      for k in [k for k in os.environ if k.startswith('BENCH_')]:
        del os.environ[k]
      os.environ.update(env)
      _zero_launches()
      t0 = time.perf_counter()
      rec = bench.main(iters=iters)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
      launches = _launches()
    T = int(env.get('BENCH_STEPS', 0)) or 100
    K = int(env.get('BENCH_PIPELINE', 4))
    steps = T * (1 + K * iters)           # the warm chunk, then the timed
    if name == 'auto':
      n = 1 + K * iters
      want = _expect(mega_rollout=n + 3, traj_raster=n)   # + mega_smoke
      if rec['solver'] != 'mega' or rec.get('mega_smoke') != \
          'Urchin:ok,LuxoCube:ok,Object3:ok':
        raise RuntimeError(f'bench auto line: {rec}')
    elif name == 'sub':
      want = _expect(substep_solver=steps * 3, lcd_raster=steps)
    else:
      want = _expect(lcd_raster=steps)
    log(f'[entry] bench {name}: {rec["value"]} env-steps/s '
        f'({rec["metric"]}, {rec["solver"]}) on {smi}; {wall:.1f} s; '
        f'launches {launches}')
    if launches != want or rec['metric'] != 'env_steps_per_sec_urchin_4096' \
        or not rec['value'] > 0 or rec['card'] != smi:
      raise RuntimeError(f'bench {name}: {rec}; launches {launches}, '
                         f'not {want}')
    out[name] = dict(rec=rec, launches=launches, wall_s=wall,
                     busy_share=_bench_busy(rec['solver'], T))
  return out


def _bench_busy(kind, T):
  """The device's busy share of one warm bench chunk (device time over
  the call's wall time): T steps of `kind` at 4096 worlds, the plain
  step's chunk cut to one step (~43,000 events a step). Device time from
  the profiler, and for the mega chunk (a few dozen launches, within the
  launch queue) from CUDA events too."""
  from boxlcd_tpu_torch import bench
  T = 1 if kind == 'jnp' else T
  env = bench.make_env('Urchin', 8, 4, torch.device('cuda'))
  chunk = bench.make_chunk(env, kind, T)
  gen = torch.Generator(device='cuda').manual_seed(0)
  st = Env.reset(env, gen, 4096)
  acts = torch.rand((T, 4096, env.act_size), generator=gen,
                    device='cuda') * 2 - 1
  st, _ = chunk(st, acts)
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    chunk(st, acts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  dev_ms, events = _device_time(prof)
  busy = (dev_ms or 0.0) / 1e3 / wall
  log(f'[entry] bench {kind} busy share: {busy:.4f} (device '
      f'{_fmt(dev_ms)} in {events} events of {wall * 1e3:.1f} ms, one chunk '
      f'of {T} steps, profiled)')
  out = dict(profiled=busy, device_ms=dev_ms, events=events,
             wall_ms=wall * 1e3)
  if kind == 'mega':
    ev = events_ms(lambda: chunk(st, acts), 3)
    w = wall_ms(lambda: chunk(st, acts), 3)
    out.update(events_busy=ev / w, events_device_ms=ev, events_wall_ms=w)
    log(f'[entry] bench mega busy share: {ev / w:.4f} (device {ev:.3f} ms '
        f'a chunk by CUDA events, behind a sleep; {w:.3f} ms a chunk with '
        f'dispatch, synchronised)')
  return out


def entry_points_phase(dev, smi, tmp):
  """--mesh=dpN (N = the card count) through the CLIs against unsharded
  runs, --mesh=dp{N+1} raising, graft_entry's entry and dryrun_multichip,
  and the port's bench.py lines; reuses phase 12's data, BVAE flags and FBT
  (`tmp`)."""
  from boxlcd_tpu_torch import graft_entry
  set_tf32(False)
  N = torch.cuda.device_count()
  writer = ScalarWriter()
  saved_writer = research_utils.make_writer
  research_utils.make_writer = lambda logdir: writer
  out = {'cards': N}
  try:
    out['collect'] = _entry_collect(tmp, N)
    out['train'] = _entry_train(tmp, N)
    out['ppo'] = _entry_ppo(tmp, N, writer)
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    y = fn(*args)
    if y.device.type != 'cuda' or not bool(torch.isfinite(y).all()):
      raise RuntimeError(f'graft_entry.entry: {y.device} {y.shape}')
    log(f'[entry] graft_entry.entry(): {tuple(y.shape)} on {y.device}')
    graft_entry.dryrun_multichip(N)
    out['dryrun_s'] = time.perf_counter() - t0
    log(f'[entry] entry + dryrun_multichip({N}): {out["dryrun_s"]:.1f} s')
    _mesh_raises('graft_entry.dryrun_multichip',
                 lambda: graft_entry.dryrun_multichip(N + 1), N + 1)
  finally:
    research_utils.make_writer = saved_writer
  out['bench'] = _entry_bench(smi)
  return out

# phase 18, the research tools and the measurement scripts: on phase 12's
# data, BVAE and FBT, phase 14's FIT and phase 15's dream PPO checkpoint
TOOLS_PROBE = ['--probe_B=64', '--probe_T=25']   # model_probe's defaults
TOOLS_FIT_B = 16                                 # fit_diag's default
TOOLS_EXIT = ['Urchin', '64', '1']    # at 180/60; T = 1 of its 20
TOOLS_GATE_B, TOOLS_GATE_T = 64, 5     # the probes' card batch vs plain
TOOLS_AGREE = 1e-5      # poses this close give the same frames
TOOLS_PROFILE_STEPS = 5


def _tool(label, fn, *args):
  """Run one tool with every launch count set to 0 just before; returns
  (its result, seconds, launches)."""
  _zero_launches()
  t0 = time.perf_counter()
  out = fn(*args)
  torch.cuda.synchronize()
  sec = time.perf_counter() - t0
  launches = _launches()
  log(f'[tools] {label}: {sec:.1f} s; launches {launches}')
  return out, sec, launches


def _probe_gate(dev):
  """fit_diag.rollout_batch on the card (megakernel + traj raster) against
  its plain route from the same states and actions: per-world pose errors
  within tests/test_mega.py's Urchin bounds, the first step's poses within
  1e-4, frames bit for bit wherever a (world, step)'s poses agree within
  TOOLS_AGREE."""
  env = _env('Urchin', dev, **ITERS)
  gen = torch.Generator(device=dev).manual_seed(5)
  B, T = TOOLS_GATE_B, TOOLS_GATE_T
  states = Env.reset(env, gen, B)
  acts = torch.rand((B, T, env.act_size), generator=gen, device=dev) * 2 - 1
  _zero_launches()
  card = fit_diag.rollout_batch(env, states, acts, plain=False)
  torch.cuda.synchronize()
  launches = _launches()
  plain = fit_diag.rollout_batch(env, states, acts, plain=True)
  med_b, tail_at, tail_frac, _ = MEGA_BOUNDS['Urchin']
  failures, msg = [], []
  for k in ('c', 'a'):
    err = (card[k] - plain[k]).abs().reshape(B, -1).max(1).values
    med, tail = float(err.median()), float((err > tail_at).float().mean())
    msg.append(f'{k} {med:.1e}/{tail:.3f}')
    if med >= med_b or tail >= tail_frac:
      failures.append(f'{k}: median {med:.2e}, tail {tail:.3f}')
  first = max(float((card[k][:, 0] - plain[k][:, 0]).abs().max())
              for k in ('c', 'a'))
  pose = torch.maximum((card['c'] - plain['c']).abs().flatten(2).max(-1)
                       .values, (card['a'] - plain['a']).abs().max(-1).values)
  agree = pose <= TOOLS_AGREE                                    # (B, T)
  diff = (card['lcd'] != plain['lcd']).flatten(2).any(-1)
  mism = int((diff & agree).sum())
  pro = float((card['proprio'] - plain['proprio']).abs().max())
  if first >= 1e-4:
    failures.append(f'poses after the first step differ by {first:.2e}')
  if mism or float(agree.float().mean()) < 0.5:
    failures.append(f'{mism} frames differ where the poses agree '
                    f'({float(agree.float().mean()):.3f} agree)')
  if launches != _expect(mega_rollout=1, traj_raster=1):
    failures.append(f'launches {launches}')
  log(f'[tools] probes\' real batch, card vs plain, Urchin {B} x {T}: '
      f'median/tail per world {", ".join(msg)}; first step {first:.2e}; '
      f'{float(agree.float().mean()):.3f} of frames with agreeing poses, '
      f'{mism} of them differ; proprio max err {pro:.2e}; launches '
      f'{launches}')
  if failures:
    raise RuntimeError(f'probe real batch: {failures}')
  return dict(first_step=first, agree=float(agree.float().mean()),
              mismatches=mism, proprio=pro, launches=launches)


def _profile_trace(tmp):
  """research.main --mode=train --profile=1 of phase 12's BVAE: a Chrome
  trace in the logdir holding CUDA kernel events."""
  logdir = tmp / 'profile'
  _wm_train([f'--datadir={tmp / "data"}', f'--logdir={logdir}',
             '--model=BVAE', '--profile=1',
             f'--total_itr={TOOLS_PROFILE_STEPS}',
             f'--log_n={TOOLS_PROFILE_STEPS}', *WM_COMMON, *WM_BVAE])
  traces = sorted(logdir.glob('trace_*.json'))
  if not traces:
    raise RuntimeError(f'--profile=1 wrote no trace into {logdir}')
  events = json.loads(traces[0].read_text()).get('traceEvents', [])
  kernels = [e for e in events if e.get('cat') == 'kernel']
  log(f'[tools] --profile=1: {traces[0].name}, {len(events)} events, '
      f'{len(kernels)} CUDA kernel events')
  if not kernels:
    raise RuntimeError(f'{traces[0]}: no CUDA kernel events')
  return dict(trace=traces[0].name, events=len(events),
              kernel_events=len(kernels))


def tools_phase(dev, smi, tmp, entry=None):
  """The research tools and measurement scripts on the card (phase 18);
  reuses phase 12's data, BVAE and FBT, phase 14's FIT and phase 15's
  ppo_lenv checkpoint (`tmp`), and phase 17's bench auto line (`entry`)
  where it ran."""
  set_tf32(False)
  out = {}
  saved_writer = research_utils.make_writer
  research_utils.make_writer = lambda logdir: research_utils.NullWriter()
  try:
    bis, sec, launches = _tool('bench_bisect (Urchin 4096 x 50, 8/4)',
                               bench_bisect.main, [])
    want = _expect(mega_rollout=24, traj_raster=12, lcd_raster=4)
    if launches != want:          # 6 stages x (warm + 3), 3 of them
      raise RuntimeError(f'bench_bisect launches {launches}, not {want}')
    out['bisect'] = dict(stages=bis, s=sec, launches=launches)
    rate = bis['+full_state']['msteps_per_s'] * 1e6
    lines = [('bench_bisect +full_state', str(rate), 50)]
    if entry is not None:
      lines.append(('bench auto line', json.dumps(entry['bench']['auto']
                                                  ['rec']), 100))
    out['roofline'] = {}
    for label, arg, T in lines:
      r, sec, _ = _tool(f'roofline at the {label} rate', roofline.main,
                        ['--env=Urchin', '--iters=8,4', f'--T={T}',
                         f'--steps_per_sec={arg}'])
      out['roofline'][label] = dict(r, s=sec)
    r, sec, _ = _tool('exit_probe (Urchin 180/60, 64 worlds, 1 step)',
                      exit_probe.main, TOOLS_EXIT)
    out['exit_probe'] = dict(r, s=sec)
    out['probe_gate'] = _probe_gate(dev)
    with tempfile.TemporaryDirectory() as work:
      r, sec, launches = _tool('benchmark_e2e (scaled default)',
                               benchmark_e2e.main, ['--workdir', work])
    if not r['under_one_hour'] or r['device'] != 'cuda' or r['card'] != smi:
      raise RuntimeError(f'benchmark_e2e: {r}')
    out['e2e'] = dict(r, s=sec, launches=launches)
    r, sec, launches = _tool(
        'model_probe (64 x 25)', model_probe.main,
        ['ppo', '--env=Urchin', '--vel_iters=8', '--pos_iters=4',
         f'--weightdir={tmp / "fbt"}', *TOOLS_PROBE])
    if launches != _expect(mega_rollout=1, traj_raster=1) or not all(
        np.isfinite(r[k]).all() for k in ('decode_rms', 'onestep_rms',
                                          'sensitivity')):
      raise RuntimeError(f'model_probe: launches {launches}, {r}')
    out['model_probe'] = dict(
        decode_bidx_rms=r['decode_bidx_rms'],
        onestep_mad=float(r['onestep_mad'].mean()),
        sensitivity_bidx=r['sensitivity_bidx'], s=sec, launches=launches)
    r, sec, launches = _tool(
        f'fit_diag (B {TOOLS_FIT_B})', fit_diag.main,
        ['--env=Urchin', f'--fitdir={tmp / "FIT"}',
         f'--fbtdir={tmp / "fbt"}', f'--B={TOOLS_FIT_B}',
         f'--outdir={tmp / "figs"}'])
    if launches['mega_rollout'] != 1 or not Path(r['strip']).exists():
      raise RuntimeError(f'fit_diag: launches {launches}, {r}')
    out['fit_diag'] = dict(r, s=sec, launches=launches)
    rate, sec, launches = _tool(
        'dream_diag (1 epoch of 375 dream steps)', dream_diag.main,
        ['ppo', f'--logdir={tmp / "ppo_lenv"}', f'--weightdir={tmp / "fbt"}',
         *RL_COMMON, '--steps_per_epoch=48000', '--diag_epochs=1'])
    if not 0.0 <= rate <= 1.0 or launches['lcd_raster'] < 1:
      raise RuntimeError(f'dream_diag: rate {rate}, launches {launches}')
    out['dream_diag'] = dict(rate=rate, s=sec, launches=launches)
  finally:
    research_utils.make_writer = saved_writer
  r, sec, _ = _tool('research.main --profile=1 (BVAE, 5 steps)',
                    _profile_trace, tmp)
  out['profile'] = dict(r, s=sec)
  return out


# -- phase 19: the DeepSeek-V2 world model ------------------------------------

DSV2_SEED = 2147483701      # the weights, drawn as the benchmark draws them
DSV2_MOE_LAYER = 3


def _dsv2_model(dev, tmp):
  """FBTDSV2 at the dream cell's shape (128 envs, window 25, the cell's
  BVAE), DeepSeek-V2-Lite in bfloat16, the benchmark's weight draw."""
  from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
  from boxlcd_tpu_torch.research.nets.video_models.fbt_dsv2 import FBTDSV2
  from boxlcd_tpu_torch.research.rl.main import parse
  from boxlcd_tpu_torch.research.rl.ppo import PPO
  from portbench.reference import dsv2_weights
  G = parse(['--env=Urchin', f'--device={dev}', '--num_envs=128',
             '--hidden_size=256', '--vel_iters=8', '--pos_iters=4',
             '--window=25', '--ep_len=100', f'--logdir={tmp}', 'ppo'])
  with mock.patch.object(research_utils, 'make_writer',
                         lambda logdir: research_utils.NullWriter()):
    raw = PPO(G).tenv._env
  Gm = AttrDict(G, hidden_size=64, nfilter=16, vqD=16, vqK=64, dsv2='',
                dsv2_precision='bfloat16')
  torch.manual_seed(0)
  model = FBTDSV2(raw, Gm, bvae=BVAE(raw, Gm))
  dsv2_weights.load_into(model.module, DSV2_SEED)
  return model


def _dsv2_window(model, B):
  g = torch.Generator().manual_seed(2)
  env, W, dev = model.env, model.block_size, model.device
  lcd = (torch.rand((B, W, env.lcd_h, env.lcd_w), generator=g) > 0.5) & \
      (torch.rand((B, W, env.lcd_h, env.lcd_w), generator=g) < 0.2)
  return {'lcd': lcd.float().to(dev),
          'proprio': (torch.rand((B, W, model.proprio_n), generator=g)
                      * 2 - 1).to(dev),
          'action': (torch.rand((B, W, model.act_n), generator=g)
                     * 2 - 1).to(dev)}


def _kernel_ms(fn, n, names):
  """{name: device ms a call} of the kernels whose profiler names contain
  each of `names`, over n calls of fn (warm)."""
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  out = {k: 0.0 for k in names}
  for e in prof.profiler.kineto_results.events():
    if e.device_type() != torch.autograd.DeviceType.CUDA:
      continue
    for k in names:
      if k in e.name():
        out[k] += e.duration_ns() / 1e6 / n
  return out


def _moe_bound_ms(slots, E, H, I):
  """The routed experts' least time on an H100 (portbench/yardstick_dsv2's
  moe_expert_bound): operations at 989 TFLOP/s or bytes at 3.35 TB/s (the
  experts' weights once, the rows in and out)."""
  flops = 2.0 * slots * 3 * H * I
  nbytes = 3.0 * E * H * I * 2 + 2.0 * slots * H * 2
  return max(flops / 989e12, nbytes / 3.35e12) * 1e3, \
      'flops' if flops / 989e12 >= nbytes / 3.35e12 else 'bytes'


def dsv2_phase(dev, smi, tmp):
  from boxlcd_tpu_torch.research.nets import dsv2, moe_kernel
  model = _dsv2_model(dev, tmp)
  B = 128
  wb = _dsv2_window(model, B)
  wb['z'] = model.encode_window(wb)
  u = torch.rand((B, model.z_size), device=dev,
                 generator=torch.Generator(device=dev).manual_seed(3))
  got = {}
  transformer = model.transformer

  def recorded(z, a):
    out = transformer(z, a)
    got.update(z=z.clone(), a=a.clone(), lg=out.clone())
    return out
  model.transformer = recorded
  n_moe = sum(1 for b in model.module.layers if b.moe)
  # the main path: the first onestep captures the transformer's graph (3
  # warm-up calls and the capture, each through every layer), the second
  # replays it and launches none of the module's kernels itself
  _zero_launches()
  model.onestep(dict(wb), 7, None, u=u)
  first = _launches()
  _zero_launches()
  model.onestep(dict(wb), 8, None, u=u)
  second = _launches()
  torch.cuda.synchronize()
  want = {k: 4 * n_moe for k in ('moe_gate_up', 'moe_down', 'moe_combine')}
  for k, v in want.items():
    if first[k] != v or second[k] != 0:
      raise AssertionError(f'{k}: {first[k]} launches capturing (want {v}), '
                           f'{second[k]} replaying (want 0)')
  log(f'[dsv2] onestep launches capturing {first}, replaying {second}')
  model.transformer = transformer
  with torch.no_grad():
    eager = model.module(got['z'], got['a'])
  if not torch.equal(eager, got['lg']):
    raise AssertionError('the graph\'s logits differ from the eager module\'s')
  step_ms = events_ms(lambda: model.onestep(dict(wb), 8, None, u=u), 5)
  log(f'[dsv2] onestep at 128 x 25 (graph replay): {step_ms:.3f} ms a step; '
      f'graph logits equal the eager module\'s')

  # the routed experts of one MoE layer on its own router's routes
  moe = model.module.layers[DSV2_MOE_LAYER].mlp
  g = torch.Generator(device=dev).manual_seed(4)
  N, H = B * model.block_size, model.module.cfg['hidden_size']
  x = torch.randn((N, H), generator=g, device=dev).bfloat16()
  res = torch.randn((N, H), generator=g, device=dev).bfloat16()
  e = moe.experts
  E, I = e.gate_proj.shape[0], e.gate_proj.shape[1]
  with torch.no_grad():
    w, idx = moe.route(x)
    shared = moe.shared_experts(x)
    args = (x, w, idx, e.gate_proj, e.up_proj, e.down_proj, shared, res)
    _zero_launches()
    got_k, counts = moe_kernel.moe_experts(*args)
    launches = _launches()
    plain, _ = moe_kernel.moe_experts_plain(*args)
  torch.cuda.synchronize()
  if (launches['moe_gate_up'], launches['moe_down'],
      launches['moe_combine']) != (1, 1, 1):
    raise AssertionError(f'moe_experts launched {launches}')
  # the card test's tolerance (tests/test_torch_dsv2.py): the plain version
  # sums in another order in float32, so h and y may round to neighbouring
  # bfloat16 values
  d = (got_k.float() - plain.float()).abs()
  rms = plain.float().pow(2).mean().sqrt()
  bad = int((d > 2 ** -7 * plain.float().abs() + 2 ** -4 * rms).sum())
  if bad or d.mean() > 2 ** -8 * rms:
    raise AssertionError(f'moe_experts against its plain version: {bad} '
                         f'outside, mean {float(d.mean()):.3g}, rms '
                         f'{float(rms):.3g}')
  slots = N * idx.shape[1]
  bound, by = _moe_bound_ms(slots, E, H, I)
  with torch.no_grad():
    ks = _kernel_ms(lambda: moe_kernel.moe_experts(*args), 5,
                    ('moe_gate_up_kernel', 'moe_down_kernel',
                     '_combine_kernel'))
    plain_ms = wall_ms(lambda: moe_kernel.moe_experts_plain(*args), 1)
  gemm_ms = ks['moe_gate_up_kernel'] + ks['moe_down_kernel']
  lib_ms, lib_note = None, 'torch._grouped_mm absent'
  grouped = getattr(torch, '_grouped_mm', None)
  if grouped is not None:
    order, cnt = moe_kernel.plan(idx, E)
    xs = x[order // idx.shape[1]]
    offs = torch.cumsum(cnt, 0, dtype=torch.int32)

    def library():
      hg = grouped(xs, e.gate_proj.transpose(-2, -1), offs=offs)
      hu = grouped(xs, e.up_proj.transpose(-2, -1), offs=offs)
      return grouped(torch.nn.functional.silu(hg) * hu,
                     e.down_proj.transpose(-2, -1), offs=offs)
    try:
      with torch.no_grad():
        lib_ms = events_ms(library, 5)
      lib_note = ('three torch._grouped_mm and silu * mul on the sorted '
                  'rows (the same GEMMs; no gather, no combine)')
    except RuntimeError as err:
      lib_note = f'torch._grouped_mm refused: {str(err)[:120]}'
  tiled = int(moe_kernel.rows_tiled(counts))
  log(f'[dsv2] moe_experts at {N} tokens, {slots} slots, {E} experts '
      f'(busiest {int(counts.max())}, idle {int((counts == 0).sum())}): '
      f'GEMMs {gemm_ms:.4f} ms (gate/up {ks["moe_gate_up_kernel"]:.4f}, '
      f'down {ks["moe_down_kernel"]:.4f}) bound_ms={bound:.4f} ({by}; '
      f'{100 * bound / gemm_ms:.1f}% of it); tiles cover {tiled} rows, '
      f'tiling share {slots / tiled:.4f}; combine '
      f'{ks["_combine_kernel"]:.4f} ms; plain {plain_ms:.1f} ms (wall); '
      f'library {_fmt(lib_ms)} ({lib_note}); max |kernel - plain| '
      f'{float(d.max()):.3g} (rms {float(rms):.3g})')

  # MLA's core (eager torch, no kernel of the port) beside SDPA on the
  # rotated q and k, the same function
  mla = model.module.layers[DSV2_MOE_LAYER].self_attn
  T = model.block_size
  with torch.no_grad():
    h = torch.randn((B, T, H), generator=g, device=dev).bfloat16()
    q = mla.q_proj(h).view(B, T, mla.nh, mla.dn + mla.dr)
    c_kv, k_pe = mla.kv_a_proj_with_mqa(h).split([mla.rank, mla.dr], -1)
    kv = mla.kv_b_proj(mla.kv_a_layernorm(c_kv)).view(
        B, T, mla.nh, mla.dn + mla.dv)
    cis = model.module.rope_cis[:T]
    bias = model.module.causal_bias[:T, :T]
    core = lambda: dsv2.attend(q, kv, k_pe, cis, bias, mla.scale)
    qr = torch.cat([q[..., :mla.dn], dsv2.rotate(q[..., mla.dn:], cis)], -1)
    kr = torch.cat([kv[..., :mla.dn], dsv2.rotate(k_pe, cis)[:, :, None]
                    .expand(B, T, mla.nh, mla.dr)], -1)
    qs, ks_, vs = (t.transpose(1, 2) for t in
                   (qr, kr, kv[..., mla.dn:].contiguous()))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks_, vs, is_causal=True, scale=mla.scale)
    y_core = core()
    y_sdpa = sdpa().transpose(1, 2).reshape(B, T, -1)
    core_ms, sdpa_ms = events_ms(core, 5), events_ms(sdpa, 5)
  dq = mla.dn + mla.dr
  flops = 2.0 * B * mla.nh * T * T * (dq + mla.dv)
  nbytes = 2.0 * (q.numel() + kv.numel() + k_pe.numel() + y_core.numel())
  att_bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
  gap = float((y_core.float() - y_sdpa.float()).abs().max())
  log(f'[dsv2] MLA core at {B} x {T}, {mla.nh} heads: eager {core_ms:.4f} '
      f'ms bound_ms={att_bound:.4f} (bytes); library (SDPA on rotated q, '
      f'k) {sdpa_ms:.4f} ms; max |eager - SDPA| {gap:.3g}')
  out = {'onestep_ms': step_ms, 'launches_capture': first,
         'launches_replay': second, 'moe_max_abs_err': float(d.max()),
         'moe_gemm_ms': gemm_ms, 'moe_gate_up_ms': ks['moe_gate_up_kernel'],
         'moe_down_ms': ks['moe_down_kernel'],
         'combine_ms': ks['_combine_kernel'], 'moe_plain_ms': plain_ms,
         'moe_bound_ms': bound, 'moe_bound_by': by, 'moe_library_ms': lib_ms,
         'moe_rows_tiled': tiled, 'moe_tiling_share': slots / tiled,
         'moe_library': lib_note, 'mla_core_ms': core_ms,
         'mla_bound_ms': att_bound, 'mla_library_ms': sdpa_ms,
         'mla_sdpa_gap': gap}
  del model, moe, mla, e
  torch.cuda.empty_cache()
  return out


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--out', default=None, help='also write the results here')
  ap.add_argument('--phases', default='',
                  help='rehearsal: run only these phases (comma list of '
                       'the names below; the build always runs); prints '
                       'no result line')
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  dev = torch.device('cuda')
  t_start = time.time()
  smi = card_phase()
  build, ptxas = build_phase()
  phase_s = {}

  only = set(filter(None, args.phases.split(',')))

  def run(name, fn, *a):
    if only and name not in only:
      return None
    t0 = time.time()
    out = fn(*a)
    phase_s[name] = time.time() - t0
    log(f'[{name}] phase done in {phase_s[name]:.1f} s')
    return out

  kern = run('kernel', kernel_phase, dev)
  traj = run('traj', traj_phase, dev)
  meg, mega_refs = run('mega', mega_phase, dev) or (None, None)
  ref = run('reference', reference_phase, dev)
  sol = run('solver', solver_phase, dev, mega_refs)
  main_run = run('main', main_path_phase, dev, smi)
  step_run = run('per-step', per_step_phase, dev, smi)
  sol_path = run('solver-path', solver_path_phase, dev, smi)
  vec = run('vec-env', vec_env_phase, dev, smi)
  with tempfile.TemporaryDirectory() as tmp:
    wm, (bvae, fbt) = run('world-model', world_model_phase, dev, smi,
                          Path(tmp)) or (None, (None, None))
    ev = run('evaluation', evaluation_phase, dev, smi, Path(tmp), bvae, fbt)
    vm, models = run('video-models', video_model_phase, dev, smi,
                     Path(tmp)) or (None, {'FRNLD': None})
    lenv = run('learned-env', learned_env_phase, dev, smi, Path(tmp), bvae,
               fbt, models['FRNLD'])
    rl = run('rl', rl_phase, dev, smi, Path(tmp))
    viz = run('viz', viz_phase, dev, smi, Path(tmp))
    entry = run('entry', entry_points_phase, dev, smi, Path(tmp))
    tools = run('tools', tools_phase, dev, smi, Path(tmp), entry)
    moe = run('dsv2', dsv2_phase, dev, smi, Path(tmp))
  if only:
    log(f'[done] phases {sorted(phase_s)} in {time.time() - t_start:.1f} s '
        f'(a rehearsal: no result line)')
    return 0
  lt, tt, mt = kern['times'][TRIPWIRE_FRAMES], traj['times'], meg['times']
  launches = main_run['launches']
  sk = sol_path['kernels']
  kernels = [{
      'name': 'mega_rollout', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/mega_rollout.cu',
      'replaces': 'boxlcd_tpu/engine/mega.py:1673',
      'launches': launches['mega_rollout'], 'max_abs_err': meg['max_abs_err'],
      'ms': mt['ms'], 'plain_ms': mt['plain_ms'], 'bound_ms': mt['bound_ms'],
      'bound_by': mt['bound_by'], 'library_ms': None,
  }, {
      'name': 'traj_raster', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/traj_raster.cu',
      'replaces': 'boxlcd_tpu/render/traj_raster.py:223',
      'launches': launches['traj_raster'], 'mismatches': traj['mismatches'],
      'max_abs_err': traj['max_abs_err'],
      'ms': tt['ms'], 'plain_ms': tt['plain_ms'], 'bound_ms': tt['bound_ms'],
      'bound_by': tt['bound_by'], 'library_ms': None,
  }, {
      'name': 'lcd_raster', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/lcd_raster.cu',
      'replaces': 'boxlcd_tpu/render/pallas_raster.py:131',
      'launches': launches['lcd_raster'], 'mismatches': kern['mismatches'],
      'max_abs_err': kern['max_abs_err'],
      'ms': lt['ms'], 'plain_ms': lt['plain_ms'], 'bound_ms': lt['bound_ms'],
      'bound_by': lt['bound_by'], 'library_ms': None,
  }] + [{
      'name': f'{kind}_solver', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/batched_solver.cu',
      'replaces': f'boxlcd_tpu/engine/pallas_solver.py:{line}',
      'launches': sol_path['launches'][f'{kind}_solver'],
      'max_abs_err': sol['max_abs_err'][kind],
      'ms': sk[kind]['ms'], 'plain_ms': sk[kind]['plain_ms'],
      'bound_ms': sk[kind]['bound_ms'], 'bound_by': sk[kind]['bound_by'],
      'library_ms': None,
  } for kind, line in (('velocity', 528), ('substep', 603))] + [{
      'name': name, 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/moe_experts.cu',
      'replaces': None, 'launches': moe['launches_capture'][name],
      'max_abs_err': moe['moe_max_abs_err'], 'ms': moe[f'{name}_ms'],
      'plain_ms': moe['moe_plain_ms'], 'bound_ms': moe['moe_bound_ms'],
      'bound_by': moe['moe_bound_by'], 'library_ms': moe['moe_library_ms'],
  } for name in ('moe_gate_up', 'moe_down')] + [{
      'name': 'moe_combine', 'route': 'triton',
      'source': 'boxlcd_tpu_torch/research/nets/moe_kernel.py',
      'replaces': None, 'launches': moe['launches_capture']['moe_combine'],
      'max_abs_err': moe['moe_max_abs_err'], 'ms': moe['combine_ms'],
      'plain_ms': None, 'bound_ms': None, 'bound_by': None,
      'library_ms': None,
  }]
  # phase 17's paths, each counted from 0: the bench lines and the mesh
  # collection (the main path's count stays `launches`)
  paths = {f'bench_{k}': v['launches'] for k, v in entry['bench'].items()}
  paths['mesh_collect'] = entry['collect']['mesh']['launches']
  # phase 18's tools, each counted from 0
  tpaths = {k: tools[k]['launches'] for k in (
      'bisect', 'probe_gate', 'e2e', 'model_probe', 'fit_diag', 'dream_diag')}
  for row in kernels:
    row['launches_entry'] = {p: c[row['name']] for p, c in paths.items()}
    row['launches_tools'] = {p: c[row['name']] for p, c in tpaths.items()}
  if args.out:
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build, ptxas=ptxas, phase_s=phase_s, kernel=kern, traj=traj,
        mega=meg,
        reference=ref, solver=sol, main=main_run, per_step=step_run,
        solver_path=sol_path, vec_env=vec, world_model=wm, evaluation=ev,
        video_models=vm, learned_env=lenv, rl=rl, viz=viz, entry=entry,
        tools=tools, dsv2=moe, kernels=kernels,
        seconds=time.time() - t_start), indent=1, default=str))
  log(f'[done] {time.time() - t_start:.1f} s')
  log(smi)
  log(json.dumps({'kernels': kernels}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
