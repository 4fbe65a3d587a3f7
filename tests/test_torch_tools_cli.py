"""The model diagnostics' command lines on the CPU, end to end, over tiny
models the port's CLIs train (Luxo, 16x32 frames, 2/1 solver iterations):
model_probe over an FBT, fit_diag over a FIT and the FBT (its strip
image), dream_diag over a dream PPO checkpoint (the checkpoint's G merged
with the command line's) and its random-policy control.
"""
import pickle

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.data.collect import make_rollout_fn, write_barrel_file
from boxlcd_tpu_torch.research import main as research_main
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.rl import main as rl_main
from boxlcd_tpu_torch.research.scripts import (
    dream_diag, fit_diag, model_probe)
from boxlcd_tpu_torch.utils import AttrDict

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FAST = ['--env=Luxo', '--lcd_base=16', '--vel_iters=2', '--pos_iters=1',
        '--device=cpu']
TINY_WM = ['--bs=4', '--hidden_size=16', '--nfilter=8', '--vqK=16',
           '--vqD=4', '--n_embed=32', '--n_head=2', '--n_layer=1',
           '--log_n=1000', '--total_itr=2', '--ep_len=12']
RL = [*FAST, '--num_envs=4', '--ep_len=4', '--hidden_size=32', '--bs=16',
      '--log_n=100000']


@pytest.fixture(scope='module')
def models(tmp_path_factory):
  """Luxo barrels the port wrote; a BVAE, an FBT over it and a FIT, each
  trained 2 steps by research.main; a dream PPO run of one epoch by
  research.rl.main. Returns the root folder."""
  root = tmp_path_factory.mktemp('tools')
  G = AttrDict(lcd_base=16, vel_iters=2, pos_iters=1, ep_len=12)
  env = boxlcd_tpu_torch.env_map['Luxo'](G, device='cpu')
  fn, T = make_rollout_fn(env, pack_lcd=True)
  traj = {k: v.numpy() for k, v in
          fn(torch.Generator().manual_seed(0), 16).items()}
  for i, sub in enumerate(('train', 'test')):
    (root / 'data' / sub).mkdir(parents=True)
    write_barrel_file(root / 'data' / sub, i, T, env.lcd_w,
                      {k: v[8 * i:8 * (i + 1)] for k, v in traj.items()},
                      'native')
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(tutils, 'make_writer', lambda logdir: tutils.NullWriter())
    common = ['--mode=train', f'--datadir={root / "data"}', *FAST, *TINY_WM]
    research_main.main([*common, '--model=BVAE', '--window=4',
                        f'--logdir={root / "bvae"}'])
    research_main.main([*common, '--model=FBT', '--window=6',
                        f'--logdir={root / "fbt"}',
                        f'--weightdir={root / "bvae"}'])
    research_main.main([*common, '--model=FIT', '--window=6',
                        '--prompt_n=3', f'--logdir={root / "fit"}'])
    rl_main.main([*RL, f'--logdir={root / "ppo"}', '--lenv=1',
                  '--model=FBT', f'--weightdir={root / "fbt"}',
                  '--steps_per_epoch=24', '--total_steps=24',
                  '--train_pi_iters=1', '--train_v_iters=1', 'ppo'])
  return root


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
  monkeypatch.setattr(tutils, 'make_writer',
                      lambda logdir: tutils.NullWriter())


def test_model_probe_cli(models, capsys):
  out = model_probe.main(['ppo', *FAST, f'--weightdir={models / "fbt"}',
                          '--probe_B=4', '--probe_T=4'])
  text = capsys.readouterr().out
  assert '(probe_T=4 < window=6; padding)' in text
  assert out['onestep_frame'] == 2
  P = boxlcd_tpu_torch.env_map['Luxo'](device='cpu').pobs_size
  for k in ('decode_rms', 'onestep_rms', 'sensitivity'):
    assert np.isfinite(out[k]).all() and out[k].shape == (P,)


def test_fit_diag_cli(models, capsys):
  out = fit_diag.main([*FAST[:1], f'--fitdir={models / "fit"}',
                       f'--fbtdir={models / "fbt"}', '--B=4',
                       f'--outdir={models / "figs"}', '--device=cpu'])
  assert np.isfinite(out['log_prob']) and 0 <= out['acc'] <= 1
  assert all(0 <= out[k] <= 1 for k in ('iso_real', 'iso_fit', 'iso_fbt'))
  assert out['strip'].endswith('Luxo_fit_diag.png')
  assert (models / 'figs' / 'Luxo_fit_diag.png').exists()
  assert 'isolated-pixel fraction: FBT' in capsys.readouterr().out


def test_dream_diag_cli(models, capsys):
  argv = ['ppo', f'--logdir={models / "ppo"}',
          f'--weightdir={models / "fbt"}', *FAST, '--num_envs=4',
          '--steps_per_epoch=12', '--diag_epochs=2', '--lenv_temp=0.5']
  rate = dream_diag.main(argv)
  text = capsys.readouterr().out
  assert 'LOADED PPO' in text and 'epoch 2/2' in text
  assert 0.0 <= rate <= 1.0 and 'IN-DREAM SUCCESS RATE' in text
  G = dream_diag.merged_config(rl_main.parse(
      [a for a in argv if not a.startswith('--diag_')]))
  with open(models / 'ppo' / 'ppo.pkl', 'rb') as f:
    saved = pickle.load(f)['G']
  # the checkpoint's widths, the command line's dream knobs
  assert G.hidden_size == saved['hidden_size'] == 32
  assert (G.lenv_temp, G.steps_per_epoch, G.lenv, G.fused_rollout) == (
      0.5, 12, 1, 1)
  rate = dream_diag.main([*argv, '--diag_random=1'])
  assert 'RANDOM-POLICY control' in capsys.readouterr().out
  assert 0.0 <= rate <= 1.0
