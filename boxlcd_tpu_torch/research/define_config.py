"""Flat config "G" + env thunk factory (the port of research/define_config.py).

Same flat-AttrDict philosophy: base defaults here, env-class defaults merged
in, CLI flags auto-generated from the dict, hps.yaml inheritance handled in
research/main.py. `G.device` (default 'cuda') is the device the env and the
models run on.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

from boxlcd_tpu_torch import ENV_DG, env_map
from boxlcd_tpu_torch.utils import AttrDict


def env_fn(G, seed=None):
  """A thunk that makes G.env on G.device, seeded; with G.goals, wrapped in
  BodyGoalEnv (or CubeGoalEnv for a Cube env)."""
  def _make():
    env = env_map[G.env](G, device=G.device)
    env.seed(seed if seed is not None else G.get('seed', 0))
    if G.goals:
      from boxlcd_tpu_torch.research import wrappers
      if 'Cube' not in G.env:
        env = wrappers.BodyGoalEnv(env, G)
      else:
        env = wrappers.CubeGoalEnv(env, G)
    return env
  return _make


def config():
  G = AttrDict()
  # basics
  G.logdir = pathlib.Path('./logs/trash')
  G.weightdir = pathlib.Path('.')
  G.buffdir = pathlib.Path('.')
  G.datadir = pathlib.Path('.')
  G.arbiterdir = pathlib.Path('.')
  G.device = 'cuda'
  G.mode = 'train'
  G.model = 'BVAE'
  G.datamode = 'video'
  G.ipython_mode = 0
  G.optimize_actions = 0  # viz mode: plan actions by grad through the model
  G.interactive = 0  # viz mode: live pyglet debugger (falls back headless)
  G.eval_n = 2048         # samples pooled per Evaler rep for FVD/P-R
  G.mesh = ''             # e.g. 'dp8': data-parallel train/collect sharding
  G.device_dataset = 0    # train from a device-resident dataset (no host I/O)

  G.amp = 0
  G.total_itr = int(1e9)
  G.log_n = int(1e4)
  G.save_n = 5
  G.refresh_data = 0

  G.decode = 'multi'
  G.conv_io = 0
  G.train_barrels = -1
  G.test_barrels = 1
  G.barrel_format = 'npz'  # 'npz' (reference layout) | 'native' (bit-packed)
  G.profile = 0  # Trainer: a torch.profiler trace of the first ~50 iters
  # device_dataset=1: train steps between host reads (step count, log);
  # 1 means min(100, total_itr)
  G.steps_per_dispatch = 1
  G.grad_clip = 10.0

  G.bs = 64
  G.lr = 1e-4
  G.n_layer = 2
  G.n_head = 4
  G.n_embed = 128
  G.hidden_size = 128
  G.nfilter = 64
  G.vidstack = -1
  G.stacks_per_block = 32

  G.vqD = 128
  G.vqK = 128
  G.beta = 0.25
  G.entropy_bonus = 5e-4

  G.min_std = 1e-4
  G.data_frac = 1.0
  G.vanished = 1
  G.num_envs = 8

  G.mdn_k = 5
  G.dist_delta = 0
  G.sample_sample = 0
  G.skip_train = 0

  G.phase = 1
  G.window = 200
  G.seed = 0
  G.end2end = 0

  G.video_n = 8
  G.prompt_n = 8

  G.env = 'Dropbox'
  G.goals = 0
  G.preproc = ''  # weightdir of a frozen AE -> zstate obs (PreprocVecEnv)
  G.state_rew = 1
  G.rew_scale = 1.0
  G.free_nats = 3.0
  G.kl_scale = 1.0
  G.autoreset = 0

  # solver iteration knobs (the reference runs Box2D at 180/60 — the
  # default follows engine.spec.DEFAULT_ITERS, overridable via
  # BOXLCD_DEFAULT_ITERS; --vel_iters/--pos_iters always win)
  from boxlcd_tpu_torch.engine.spec import DEFAULT_ITERS
  G.vel_iters = DEFAULT_ITERS[0]
  G.pos_iters = DEFAULT_ITERS[1]
  # >0: velocity-loop convergence exit at this impulse-delta tol + exact
  # Box2D NGS break (see WorldSpec.solver_exit_tol); 0 = fixed trip counts
  G.solver_exit_tol = 0.0

  G.full_cmd = 'python ' + ' '.join(sys.argv)
  try:
    G.commit = subprocess.check_output(
        ['git', 'rev-parse', '--short', 'HEAD'], stderr=subprocess.DEVNULL,
        cwd=pathlib.Path(__file__).parent).strip().decode('utf-8')
  except (subprocess.CalledProcessError, OSError):
    G.commit = 'unknown'
  G.num_vars = 0

  past = set(G.keys())
  for key, val in ENV_DG.items():
    if key in past:
      raise ValueError(f'duplicate config key {key}')
    G[key] = val
  return G
