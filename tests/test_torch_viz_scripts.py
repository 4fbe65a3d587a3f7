"""The port's media scripts and gif writers against the JAX package's:

- `research.utils.write_gif` and the Vizer's `write_gif` without Pillow:
  both packages fall back to `<path>.npz` with the same frames;
- `viz_goal`: the grid PNG written with the goal in red
  (tests/test_round4.py:7 for the port), `goal_overlay` equal to JAX's;
- `lcd_wave`: the gif written (tests/test_round4.py:19 for the port), and
  every frame equal to JAX's, bit for bit, for the same poses (past the
  wipe's start, so both renders show);
- `demo_gifs`: one gif an env, its frames the rollout's;
- `sample_model`: the truth / sample / error PNG over a saved FBT, and
  `frame_strip` equal to JAX's.
"""
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import boxlcd_tpu_torch
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.runners import vizer as tvizer
from boxlcd_tpu_torch.research.scripts import (
    demo_gifs, lcd_wave, sample_model, viz_goal)
from research import utils as jutils
from research.runners import vizer as jvizer
from research.scripts import lcd_wave as jlcd_wave
from research.scripts import sample_model as jsample_model
from research.scripts import viz_goal as jviz_goal

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def _gif_frames(path, mode='L'):
  with Image.open(path) as im:
    frames = []
    for i in range(im.n_frames):
      im.seek(i)
      frames.append(np.asarray(im.convert(mode)))
  return np.stack(frames)


@pytest.mark.parametrize('writers', [(tutils.write_gif, jutils.write_gif),
                                     (tvizer.write_gif, jvizer.write_gif)],
                         ids=['research_utils', 'vizer'])
def test_write_gif_falls_back_to_npz_without_pillow(tmp_path, monkeypatch,
                                                    writers):
  frames = np.random.RandomState(0).rand(3, 4, 8) > 0.5
  monkeypatch.setitem(sys.modules, 'PIL', None)   # import PIL raises
  port, jax_ = writers
  got = port(tmp_path / 'port.gif', frames)
  want = jax_(tmp_path / 'jax.gif', frames)
  assert got == str(tmp_path / 'port.gif.npz')
  if want is not None:     # the JAX Vizer's writer returns nothing
    assert want == str(tmp_path / 'jax.gif.npz')
  assert not (tmp_path / 'port.gif').exists()
  a = np.load(tmp_path / 'port.gif.npz')['frames']
  b = np.load(tmp_path / 'jax.gif.npz')['frames']
  assert a.dtype == b.dtype and np.array_equal(a, b)
  assert np.array_equal(a, frames)


def test_write_gif_with_pillow(tmp_path):
  frames = np.random.RandomState(0).rand(3, 4, 8) > 0.5
  path = tutils.write_gif(tmp_path / 'a.gif', frames)
  assert path == str(tmp_path / 'a.gif')
  got = _gif_frames(path)
  assert got.shape == (3, 32, 64)
  assert np.array_equal(got > 127, frames.repeat(8, 1).repeat(8, 2))


def test_viz_goal_writes_grid(tmp_path):
  path = viz_goal.main(['--env=Luxo', f'--outdir={tmp_path}', '--rows=1',
                        '--cols=2', '--device=cpu'])
  assert path == tmp_path / 'Luxo_goals.png' and path.exists()
  img = np.asarray(Image.open(path))
  assert img.ndim == 3 and img.shape == (16 * 8, (2 * 32 + 1) * 8, 3)
  # the goal silhouette is red-tinted somewhere: R > G pixels
  assert (img[..., 0].astype(int) > img[..., 1].astype(int) + 64).any()


def test_goal_overlay_matches_jax():
  env = boxlcd_tpu_torch.env_map['Luxo'](device='cpu')
  from boxlcd_tpu_torch.research.wrappers import BodyGoalEnv
  genv = BodyGoalEnv(env, tconfig())
  genv.seed(1)
  for _ in range(2):
    obs = genv.reset()
    got = viz_goal.goal_overlay(obs)
    assert np.array_equal(got, jviz_goal.goal_overlay(obs))
    assert got.shape == (env.lcd_h, env.lcd_w, 3)


def test_lcd_wave_writes_gif(tmp_path):
  path = lcd_wave.main(['--env=Bounce', '--steps=6', f'--outdir={tmp_path}',
                        '--device=cpu'])
  assert path == tmp_path / 'Bounce_wave.gif' and path.exists()


def test_lcd_wave_matches_jax(tmp_path, monkeypatch):
  """12 steps: the LCD wipe starts at step 11, so the last frames hold
  both renders."""
  import jax.numpy as jnp
  env = boxlcd_tpu_torch.env_map['Bounce'](device='cpu')
  poses = lcd_wave.rollout_poses(env, torch.Generator().manual_seed(7), 12)
  monkeypatch.setattr(lcd_wave, 'rollout_poses', lambda *a: poses)
  monkeypatch.setattr(jlcd_wave, 'rollout_poses', lambda *a: tuple(
      jnp.asarray(p.numpy()) for p in poses))
  lcd_wave.main(['--env=Bounce', '--steps=12', f'--outdir={tmp_path / "p"}',
                 '--device=cpu'])
  jlcd_wave.main(['--env=Bounce', '--steps=12', f'--outdir={tmp_path / "j"}'])
  got = _gif_frames(tmp_path / 'p' / 'Bounce_wave.gif', 'RGB')
  want = _gif_frames(tmp_path / 'j' / 'Bounce_wave.gif', 'RGB')
  assert got.shape == want.shape == (12, 256, 258, 3)
  assert np.array_equal(got, want)
  frames = lcd_wave.wave_frames(env, *poses)
  assert len(frames) == 12 and frames[-1].shape == (256, 258, 3)
  # the first frame is the separator and the RGB render; in the last the
  # binary LCD holds int(0.9 * 16 * (11 - 10)) = 14 columns
  assert not frames[0][:, :2].any()
  assert not frames[-1][:, 14:16].any()
  assert set(np.unique(frames[-1][:, :14])) <= {0.0, 1.0}


def test_demo_gifs(tmp_path):
  paths = demo_gifs.main(['--envs=Dropbox,Bounce', '--steps=3',
                          f'--outdir={tmp_path}', '--device=cpu'])
  assert set(paths) == {'Dropbox', 'Bounce'}
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  frames = demo_gifs.rollout_frames(env, torch.Generator().manual_seed(0), 3)
  got = _gif_frames(paths['Dropbox'])
  assert frames.shape == (3, env.lcd_h, env.lcd_w)
  assert np.array_equal(got > 127, frames.repeat(8, 1).repeat(8, 2) > 0.5)


def test_sample_model_and_frame_strip(tmp_path):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = tconfig()
  G.update(hidden_size=16, nfilter=8, vqD=4, vqK=16, n_embed=32, n_head=2,
           n_layer=1, window=5, bs=4, lr=1e-3, env='Dropbox', device='cpu',
           weightdir=tmp_path / 'm', wh_ratio=env.G.wh_ratio,
           lcd_base=env.G.lcd_base)
  bvae = BVAE(env, G)
  bvae.save(tmp_path / 'm')
  FBT(env, G, bvae=bvae).save(tmp_path / 'm')
  path, truth, pred = sample_model.main([
      '--env=Dropbox', '--model=FBT', f'--weightdir={tmp_path / "m"}',
      f'--outdir={tmp_path / "fig"}', '--frames=4', '--fig_prompt_n=2',
      '--device=cpu'])
  img = np.asarray(Image.open(path))
  H, W = env.lcd_h, env.lcd_w
  assert truth.shape == pred.shape == (5, H, W)
  assert img.shape == ((3 * H + 2) * 8, (4 * W + 3) * 8, 3)
  want = jsample_model.frame_strip(truth, pred, 2, 4)
  got = sample_model.frame_strip(truth, pred, 2, 4)
  assert np.array_equal(got, want)
  assert np.array_equal(img, (255 * got).astype(np.uint8))
  # the red separator after the prompt
  sep = got[:, 2 * W * 8 + 8:2 * W * 8 + 16]
  assert (sep[..., 0] == 1).all() and not sep[..., 1:].any()
