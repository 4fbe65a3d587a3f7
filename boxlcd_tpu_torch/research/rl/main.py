"""RL entry point of the port (the port of research/rl/main.py):

    python -m boxlcd_tpu_torch.research.rl.main ppo|sac [--flags]

`rl_config` holds every RL key and default of the JAX package's; `parse`
merges them with the research config and the env's defaults and turns
goals and autoreset on for a known env, as JAX's does. Runs on the card
unless --device=cpu, with TF32 off."""
from __future__ import annotations

import argparse

from boxlcd_tpu_torch import env_map
from boxlcd_tpu_torch.research.define_config import config
from boxlcd_tpu_torch.utils import AttrDict, args_type, set_tf32


def rl_config():
  _G = AttrDict()
  _G.replay_size = int(1e6)
  _G.total_steps = 1000000
  _G.test_n = 1
  _G.save_freq = 10
  _G.gamma = 0.99
  _G.learned_alpha = 1
  _G.pi_lr = 3e-4
  _G.vf_lr = 1e-3
  _G.alpha = 0.1
  _G.alpha_lr = 1e-4
  _G.polyak = 0.995
  _G.num_test_episodes = 2
  _G.update_every = 40
  _G.start_steps = 1000
  _G.update_after = 1000
  _G.use_done = 1
  _G.net = 'mlp'
  _G.zdelta = 1
  _G.lenv = 0
  _G.lenv_mode = 'swap'
  _G.lenv_temp = 1.0
  _G.lenv_cont_roll = 0
  _G.lenv_goals = 0
  _G.lenv_test = 1
  _G.reset_prompt = 1
  _G.succ_reset = 1
  _G.state_key = 'proprio'
  _G.diff_delt = 0
  _G.goal_thresh = 0.05
  _G.preproc_rew = 0
  _G.preproc_net = 'BVAE'  # which AE class the preproc weights belong to
  _G.learned_rew = 0
  _G.clip_ratio = 0.2
  _G.train_pi_iters = 80
  _G.train_v_iters = 80
  _G.lam = 0.97
  _G.steps_per_epoch = 4000
  _G.target_kl = 0.01
  _G.kl_stop = 0  # reference's KL early stop is commented out (ppo.py:82-83)
  _G.test_deterministic = 0  # reference tests/evals with pi.sample()
  _G.firehose = 0
  _G.fused_rollout = 1  # PPO epoch rollouts on the device, one host copy
  _G.resume = 0  # 1: resume from logdir/ppo_last.pkl if present (epoch kept)
  _G.early_stop_succ = 0.0  # >0: stop once real-test success holds >= this
  _G.early_stop_n = 4       # ... for this many consecutive test cycles
  return _G


def parse(argv=None):
  parser = argparse.ArgumentParser()
  for key, value in config().items():
    parser.add_argument(f'--{key}', type=args_type(value), default=value)
  for key, value in rl_config().items():
    parser.add_argument(f'--{key}', type=args_type(value), default=value)
  parser.add_argument('algo')
  tempC, _ = parser.parse_known_args(argv)
  if tempC.env in env_map:
    parser.set_defaults(**env_map[tempC.env].ENV_DG)
    parser.set_defaults(**{'goals': 1, 'autoreset': 1})
  G = AttrDict(vars(parser.parse_args(argv)))
  G.lcd_w = int(G.wh_ratio * G.lcd_base)
  G.lcd_h = G.lcd_base
  G.imsize = G.lcd_w * G.lcd_h
  from pathlib import Path
  for p in ['logdir', 'datadir', 'weightdir', 'arbiterdir', 'buffdir']:
    G[p] = Path(G[p])
  return G


def main(argv=None):
  """Train G.algo; returns the trained algo."""
  set_tf32(False)   # float32 is float32 on the card
  G = parse(argv)
  if G.algo == 'ppo':
    from boxlcd_tpu_torch.research.rl.ppo import PPO
    algo = PPO(G)
    if G.get('resume') and (G.logdir / 'ppo_last.pkl').exists():
      algo.load(G.logdir, name='ppo_last.pkl')
    algo.run()
  elif G.algo == 'sac':
    from boxlcd_tpu_torch.research.rl.sac import SAC
    algo = SAC(G)
    algo.run_firehose() if G.firehose else algo.run()
  else:
    raise ValueError(G.algo)
  return algo


if __name__ == '__main__':
  main()
