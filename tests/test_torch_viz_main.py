"""The port's research.main visualisation modes end to end on the CPU, over a
tiny FBT over a BVAE that the port's research.main trained on Luxo barrels
the port wrote (fast physics, 2/1 solver iterations):

- `--mode=viz`, with `--optimize_actions=1` (4 rollouts, 4 plans) and with
  `--interactive=1` (no pyglet here: the headless replay);
- `--mode=fiddle`: the sensitivities in vec_weights.pkl within 1e-5 of the
  JAX Fiddler's on the same batch and the same normals (JAX's, drawn from
  its key chain), the BVAE's parameters carried to flax by the inverse of
  research/nets/convert.py;
- `--ipython_mode=1` with `IPython.embed` stood in: env, G and the loaded
  model in the REPL's scope;
- `WorldEnv.render('human')` equal to the JAX env's image, bit for bit, on
  the same state (LuxoCube: robot and object colours), through an
  `ArrayViewer`; the viewer's own surface.
"""
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.engine import physics as jphysics
from boxlcd_tpu.render import raster as jraster
from boxlcd_tpu_torch import viewer
from boxlcd_tpu_torch.data.collect import make_rollout_fn, write_barrel_file
from boxlcd_tpu_torch.data.dataset import load_ds as tload_ds
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.research import main as research_main
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.nets import convert
from boxlcd_tpu_torch.research.nets._base import Net
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.runners import fiddler as tfiddler
from boxlcd_tpu_torch.utils import AttrDict
from research.define_config import config as jconfig
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.runners import fiddler as jfiddler

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FAST = ['--env=Luxo', '--lcd_base=16', '--vel_iters=2', '--pos_iters=1',
        '--device=cpu']
TINY_WM = ['--bs=4', '--hidden_size=16', '--nfilter=8', '--vqK=16',
           '--vqD=4', '--n_embed=32', '--n_head=2', '--n_layer=1',
           '--log_n=1000', '--total_itr=2']


class NoWriter:
  def add_scalar(self, *a, **k):
    pass

  add_image = add_video = flush = add_scalar


@pytest.fixture(scope='module')
def root(tmp_path_factory):
  """data/ (Luxo barrels, 8 episodes of 12 steps each split), bvae/ and
  fbt/ (window 6, prompt_n 2), each model trained 2 steps by the port's
  research.main."""
  root = tmp_path_factory.mktemp('viz')
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
    mp.setattr(tutils, 'make_writer', lambda logdir: NoWriter())
    common = ['--mode=train', f'--datadir={root / "data"}', *FAST,
              '--ep_len=12', *TINY_WM]
    research_main.main([*common, '--model=BVAE', '--window=4',
                        f'--logdir={root / "bvae"}'])
    research_main.main([*common, '--model=FBT', '--window=6',
                        '--prompt_n=2', f'--logdir={root / "fbt"}',
                        f'--weightdir={root / "bvae"}'])
  return root


def test_viz_optimize_actions(root, tmp_path, capsys):
  out = tmp_path / 'viz'
  research_main.main(['--mode=viz', '--model=FBT',
                      f'--weightdir={root / "fbt"}', f'--logdir={out}',
                      '--optimize_actions=1', *FAST])
  log = capsys.readouterr().out
  for r in range(4):
    for name in (f'viz_rollout_{r}.gif', f'viz_optimized_{r}.gif'):
      assert (out / name).stat().st_size > 0, name
  losses = [line.split('loss ')[1].split(' -> ') for line in log.splitlines()
            if line.startswith('optimize_actions rollout')]
  assert len(losses) == 4
  assert all(np.isfinite([float(a), float(b)]).all() for a, b in losses)


def test_viz_interactive_falls_back_headless(root, tmp_path, capsys):
  out = tmp_path / 'vizi'
  G, env = research_main.parse_flags([
      '--mode=viz', '--model=FBT', f'--weightdir={root / "fbt"}',
      f'--logdir={out}', '--interactive=1', *FAST])
  runner, recs = research_main.visualize(G, env, n_rollouts=1)
  assert type(runner).__name__ == 'InteractiveVizer'
  assert not runner.have_window
  assert 'headless replay instead' in capsys.readouterr().out
  (rec,) = recs
  assert (out / 'viz_rollout_0.gif').exists()
  assert rec['truth'].shape == rec['sample'].shape == (6, 16, 32)
  # the truth is the env's own frames: binary, not blank
  assert set(np.unique(rec['truth'])) <= {0.0, 1.0} and rec['truth'].any()


def state_dict_to_flax(template, sd):
  """The inverse of convert.flax_to_state_dict over a flax tree of the same
  model (`template`, for the names): the port's tensors in flax layout."""
  def walk(tree, prefix, module):
    out = {}
    for name, value in tree.items():
      if isinstance(value, dict):
        out[name] = walk(value, f'{prefix}{name}.', name)
        continue
      key, _ = convert._leaf(module, name, np.asarray(value))
      t = sd[prefix + key].detach().cpu().numpy()
      if name == 'kernel' and t.ndim == 2:
        t = t.T
      elif name == 'kernel' and module.startswith('ConvTranspose_'):
        t = t.transpose(2, 3, 0, 1)[::-1, ::-1]
      elif name == 'kernel':
        t = t.transpose(2, 3, 1, 0)
      assert t.shape == np.shape(value), (prefix + key, t.shape)
      out[name] = jnp.asarray(np.ascontiguousarray(t))
    return out
  if set(template) == {'params'}:
    return {'params': walk(template['params'], '', '')}
  return walk(template, '', '')


def test_fiddle_matches_jax(root, tmp_path, monkeypatch):
  argv = ['--mode=fiddle', '--model=BVAE', f'--weightdir={root / "bvae"}',
          f'--datadir={root / "data"}', f'--logdir={tmp_path / "port"}',
          *FAST]
  G, _ = research_main.parse_flags(argv)
  batch = next(iter(tload_ds(G)[1]))
  N, P = batch['proprio'].shape[0] * batch['proprio'].shape[1], \
      batch['proprio'].shape[-1]
  # JAX's normals: one draw of N a proprio dim, on key, k = split(key)
  key, normals = jax.random.PRNGKey(0), []
  for _ in range(P):
    key, k = jax.random.split(key)
    normals.append(np.asarray(jax.random.normal(k, (N,))))
  run = tfiddler.Fiddler.run
  monkeypatch.setattr(tfiddler.Fiddler, 'run',
                      lambda self: run(self, noise=np.stack(normals)))
  monkeypatch.setattr(tfiddler, 'load_ds', lambda G: (None, [batch]))
  research_main.main(argv)
  with open(tmp_path / 'port' / 'vec_weights.pkl', 'rb') as f:
    got = pickle.load(f)
  # the JAX Fiddler over the same BVAE weights
  tG = Net.load_config(root / 'bvae', 'BVAE')
  jG = jconfig()
  jG.update({k: v for k, v in tG.items() if k in jG and k != 'device'},
            logdir=str(tmp_path / 'jax'))
  jenv = boxlcd_tpu.env_map['Luxo'](jG)
  jm = JBVAE(jenv, jG)
  with open(root / 'bvae' / 'BVAE.pkl', 'rb') as f:
    jm.params = state_dict_to_flax(jm.params, pickle.load(f)['state_dict'])
  monkeypatch.setattr(jfiddler, 'load_ds', lambda G: (None, [batch]))
  want = jfiddler.Fiddler(jm, jenv, jG).run()
  with open(tmp_path / 'jax' / 'vec_weights.pkl', 'rb') as f:
    ref = pickle.load(f)
  assert got['sensitivity'].shape == ref['sensitivity'].shape
  assert got['sensitivity'].shape[0] == P
  assert np.abs(got['sensitivity'] - ref['sensitivity']).max() <= 1e-5
  # the weights normalise each latent dim's column: where no code bit
  # flipped, the column is float noise (~1e-7) and so are its weights; a
  # flip moves the column by 1 / frames
  flipped = ref['sensitivity'].sum(0) >= 1e-3
  assert flipped.any()
  assert np.abs(got['weights'] - np.asarray(want))[:, flipped].max() <= 1e-5


def test_ipython_mode(root, monkeypatch):
  seen = {}
  stub = types.ModuleType('IPython')
  stub.embed = lambda **kw: seen.update(sys._getframe(1).f_locals, kw=kw)
  monkeypatch.setitem(sys.modules, 'IPython', stub)
  research_main.main(['--ipython_mode=1', '--model=FBT',
                      f'--weightdir={root / "fbt"}', *FAST])
  assert isinstance(seen['model'], FBT) and seen['model'].step == 2
  assert seen['env'].lcd_h == 16 and seen['G'].model == 'FBT'
  assert seen['kw'] == {'colors': 'neutral'}
  # without a weightdir: env and G only
  seen.clear()
  research_main.main(['--ipython_mode=1', *FAST])
  assert seen['model'] is None and 'env' in seen


def test_render_human_matches_jax(monkeypatch):
  """The JAX env and the port's on one state (the port's reset, carried
  over): the same composed image. JAX's renderers run jitted here (op by
  op they compile for ~15 s on the CPU)."""
  for name in ('rgb_render', 'lcd_render'):
    fn = getattr(jraster, name)
    monkeypatch.setattr(jraster, name, lambda spec, ic, c, a, w, h, fn=fn:
                        jax.jit(lambda *x: fn(spec, *x, w, h))(ic, c, a))
  jenv = boxlcd_tpu.env_map['LuxoCube']()
  env = boxlcd_tpu_torch.env_map['LuxoCube'](device='cpu')
  env.seed(2)
  env.reset()
  st = physics.state_to_numpy(env.state)
  jenv._state = jphysics.WorldState(
      **{f: jnp.asarray(st[f][0]) for f in jphysics.WorldState._fields})
  want = jenv.render('human')
  got = env.render('human')
  H, W = env.lcd_h, env.lcd_w
  assert got.shape == (8 * H, 16 * W + 1, 3) and got.dtype == np.uint8
  assert np.array_equal(got, want)
  # both colours are drawn, and the LCD half is the lcd render upscaled
  assert (got[..., 0] > got[..., 2]).any() and (got[..., 2] > got[..., 0]).any()
  lcd = env.lcd_render()
  assert np.array_equal(got[:, 8 * W + 1:, 0],
                        (255 * lcd.astype(np.uint8)).repeat(8, 0).repeat(8, 1))
  assert not got[:, 8 * W].any()
  # the headless viewer kept the frame; return_pyglet_view reads it back
  assert isinstance(env.viewer, viewer.ArrayViewer)
  assert np.array_equal(env.viewer.frames[-1], got)
  assert np.array_equal(env.render('human', return_pyglet_view=True), got)


def test_array_viewer():
  v = viewer.make_viewer(32, 16)
  assert not viewer.HAVE_PYGLET and isinstance(v, viewer.ArrayViewer)
  with pytest.raises(RuntimeError):
    viewer.Viewer(32, 16)
  v = viewer.ArrayViewer(32, 16, keep=3)
  imgs = [np.full((16, 32, 3), i, np.uint8) for i in range(5)]
  for img in imgs:
    assert v.render(img) is None
  assert [int(f[0, 0, 0]) for f in v.frames] == [2, 3, 4]
  assert np.array_equal(v.render(imgs[0], return_rgb_array=True), imgs[0])
  v.close()
  assert v.frames == []
