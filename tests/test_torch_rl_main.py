"""The port's RL entry points end to end on the CPU, at tiny widths and
fast physics (2/1 solver iterations):

- `rl.main.parse` gives JAX's keys and defaults for the same argv (the
  device's default is the card's name, not the TPU's);
- `define_config.env_fn` with goals=1 wraps as JAX's does (BodyGoalEnv,
  CubeGoalEnv for a Cube env) with JAX's observation keys;
- `rl.main ppo`: the real env, fused and unfused, 2 epochs; ppo.pkl and
  ppo_last.pkl written, every logged value finite, the reloaded policy's
  mean actions bit for bit; then `eval_policy` on the checkpoint
  (ITERS x N_ENVS cut to 1 x 4, the evidence folder redirected);
- `rl.main ppo --lenv=1` over a tiny FBT over a BVAE that the port's
  research.main trained on port-written barrels (the fused learned-env
  epoch, the learned test env);
- `rl.main sac`: `run` (real env, cnn: the replay buffer and one
  update_every burst) and `run_firehose` (the learned env, mlp);
- `--mesh` raises JAX's assertions where JAX's does: a mesh that is not
  data-parallel, and a num_envs that does not divide over its devices (the
  sharded epochs themselves: tests/test_torch_mesh.py).
"""
import json
import pickle

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.data.collect import make_rollout_fn, write_barrel_file
from boxlcd_tpu_torch.research import main as research_main
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.define_config import env_fn as tenv_fn
from boxlcd_tpu_torch.research.rl import main as tmain
from boxlcd_tpu_torch.research.rl.ppo import PPO
from boxlcd_tpu_torch.research.scripts import eval_policy
from boxlcd_tpu_torch.utils import AttrDict
from research.define_config import env_fn as jenv_fn
from research.rl import main as jmain

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FAST = ['--env=Luxo', '--lcd_base=16', '--vel_iters=2', '--pos_iters=1',
        '--device=cpu']
RL = [*FAST, '--num_envs=4', '--ep_len=4', '--hidden_size=32', '--bs=16',
      '--log_n=100000']
TINY_WM = ['--bs=4', '--hidden_size=16', '--nfilter=8', '--vqK=16',
           '--vqD=4', '--n_embed=32', '--n_head=2', '--n_layer=1',
           '--log_n=1000', '--total_itr=2']


class Logged:
  """The writer's surface, keeping the scalars (a TensorBoard writer
  would import TensorFlow, ~10 s here)."""

  def __init__(self):
    self.scalars = []

  def add_scalar(self, tag, value, *a, **k):
    self.scalars.append((tag, value))

  def add_image(self, *a, **k):
    pass

  add_video = add_image

  def flush(self):
    pass


@pytest.fixture
def writer(monkeypatch):
  w = Logged()
  monkeypatch.setattr(tutils, 'make_writer', lambda logdir: w)
  return w


def _finite(writer):
  assert writer.scalars
  bad = [(k, v) for k, v in writer.scalars if not np.isfinite(v)]
  assert not bad, bad


@pytest.mark.parametrize('argv', [
    ['ppo'], ['sac'], ['--env=UrchinCube', '--num_envs=16', 'sac'],
    ['--env=Luxo', '--lenv=1', '--lcd_base=16', 'ppo']])
def test_parse_matches_jax(argv):
  got, want = tmain.parse(argv), jmain.parse(argv)
  assert set(got) == set(want)
  assert (got.device, want.device) == ('cuda', 'tpu')
  differ = {k for k in want if got[k] != want[k]}
  assert differ <= {'device', 'commit', 'full_cmd'}, differ
  assert got.goals == 1 and got.autoreset == 1


@pytest.mark.parametrize('env_name,wrapper', [('Luxo', 'BodyGoalEnv'),
                                              ('LuxoCube', 'CubeGoalEnv')])
def test_env_fn_wraps_goals_as_jax(env_name, wrapper):
  argv = [f'--env={env_name}', '--vel_iters=2', '--pos_iters=1', 'ppo']
  tenv = tenv_fn(tmain.parse(['--device=cpu', *argv]), 3)()
  jenv = jenv_fn(jmain.parse(argv), 3)()
  assert type(tenv).__name__ == type(jenv).__name__ == wrapper
  tsp, jsp = tenv.observation_space.spaces, jenv.observation_space.spaces
  assert list(tsp) == list(jsp)
  for k in jsp:
    assert tsp[k].shape == jsp[k].shape, k
  obs = tenv.reset()
  assert set(obs) <= set(tsp) and {'goal:lcd', 'goal:proprio'} <= set(obs)
  assert obs['goal:proprio'].shape == tsp['goal:proprio'].shape
  # without goals, the bare env as before
  G = tmain.parse(['--device=cpu', *argv])
  G.goals = 0
  assert not hasattr(tenv_fn(G)(), '_env')


def _mean_actions(algo, obs):
  return algo.get_a(obs, deterministic=True)


@pytest.mark.parametrize('fused', [1, 0])
def test_ppo_real_env_and_eval_policy(tmp_path, writer, monkeypatch, fused):
  logdir = tmp_path / 'ppo'
  algo = tmain.main([*RL, f'--logdir={logdir}', '--steps_per_epoch=16',
                     '--total_steps=32', '--train_pi_iters=2',
                     '--train_v_iters=2', f'--fused_rollout={fused}', 'ppo'])
  assert algo._epoch == 1 and algo.buf.ptr == 0
  assert (logdir / 'ppo.pkl').exists() and (logdir / 'ppo_last.pkl').exists()
  _finite(writer)
  tags = {k for k, _ in writer.scalars}
  assert {'loss/pi', 'loss/v', 'kl', 'entropy', 'EpRet', 'test/EpRet',
          'test/success_rate', 'dt/epoch'} <= tags
  # the checkpoint reloads into a fresh algo: the same mean actions
  obs = algo.real_tvenv.reset()
  with open(logdir / 'ppo_last.pkl', 'rb') as f:
    blob = pickle.load(f)
  assert blob['epoch'] == 1 and blob['G']['fused_rollout'] == fused
  fresh = PPO(algo.G)
  fresh.load(logdir, name='ppo_last.pkl')
  assert fresh._start_epoch == 2
  assert torch.equal(_mean_actions(fresh, obs), _mean_actions(algo, obs))

  monkeypatch.setattr(eval_policy, 'ITERS', 1)
  monkeypatch.setattr(eval_policy, 'N_ENVS', 4)
  monkeypatch.setattr(eval_policy, 'EVIDENCE_DIR', tmp_path / 'evidence')
  rate = eval_policy.main([f'--logdir={logdir}', '--device=cpu', 'ppo'])
  assert 0 <= rate <= 1
  with open(logdir / 'eval_policy.pkl', 'rb') as f:
    assert pickle.load(f) == {'success_rate': rate}
  (ev,) = (tmp_path / 'evidence').glob('*.json')
  ev = json.loads(ev.read_text())
  assert ev['success_rate'] == rate and ev['episodes'] == 4
  assert ev['trained_in'] == 'real_sim' and ev['env'] == 'Luxo'


@pytest.fixture(scope='module')
def fbt_dir(tmp_path_factory):
  """A tiny FBT over a BVAE, each trained 2 steps by the port's
  research.main on Luxo barrels the port wrote; the FBT's logdir."""
  root = tmp_path_factory.mktemp('wm')
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
    mp.setattr(tutils, 'make_writer', lambda logdir: Logged())
    common = ['--mode=train', f'--datadir={root / "data"}', *FAST,
              '--ep_len=12', *TINY_WM]
    research_main.main([*common, '--model=BVAE', '--window=4',
                        f'--logdir={root / "bvae"}'])
    research_main.main([*common, '--model=FBT', '--window=6',
                        f'--logdir={root / "fbt"}',
                        f'--weightdir={root / "bvae"}'])
  return root / 'fbt'


def test_ppo_learned_env(tmp_path, writer, fbt_dir):
  logdir = tmp_path / 'ppo'
  algo = tmain.main([*RL, f'--logdir={logdir}', '--lenv=1', '--model=FBT',
                     f'--weightdir={fbt_dir}', '--steps_per_epoch=24',
                     '--total_steps=24', '--train_pi_iters=2',
                     '--train_v_iters=2', '--goal_thresh=0.3', 'ppo'])
  lenv = algo.env.lenv
  assert lenv.window == 6 and lenv.model.name == 'FBT'
  # 6 fused steps at ep_len 4: one lockstep timeout, then 2 more steps
  wb, ptr, ep_t, goals = algo._lenv_state
  assert (ptr, ep_t) == (3, 2) and wb['lcd'].shape[:2] == (4, 6)
  _finite(writer)
  tags = {k for k, _ in writer.scalars}
  assert {'EpRet', 'test/success_rate', 'lenv_test/success_rate',
          'loss/pi'} <= tags
  assert (logdir / 'ppo.pkl').exists()


def test_sac_run_and_firehose(tmp_path, writer, fbt_dir):
  # run: 2 random start steps, then one burst of update_every=8 updates at
  # t = 8 (every 8 // 4 = 2 env steps from update_after), 3 steps in all
  sac = tmain.main([*RL, '--ep_len=2', f'--logdir={tmp_path / "run"}',
                    '--net=cnn',
                    '--nfilter=8', '--total_steps=12', '--start_steps=8',
                    '--update_after=8', '--update_every=8', 'sac'])
  assert sac.buf.count == 12
  moved = [not torch.equal(p, q) for p, q in
           zip(sac.net.parameters(), sac.target.parameters())]
  assert any(moved)
  # no test and no log before t = 4000: the metrics wait in the logger
  logged = dict(sac.logger.items())
  assert {'loss/q', 'loss/pi', 'alpha', 'EpRet'} <= set(logged)
  assert all(np.isfinite(v).all() for v in logged.values())
  # firehose in the learned env: a test, a log and a save at itr 2
  writer.scalars.clear()
  fire = tmain.main([*RL, f'--logdir={tmp_path / "fire"}', '--lenv=1',
                     '--model=FBT', f'--weightdir={fbt_dir}', '--firehose=1',
                     '--total_steps=2', '--log_n=20', 'sac'])
  _finite(writer)
  assert {'loss/q', 'test/success_rate', 'lenv_test/success_rate',
          'fps'} <= {k for k, _ in writer.scalars}
  with open(tmp_path / 'fire' / 'sac.pkl', 'rb') as f:
    blob = pickle.load(f)
  fire2 = type(fire)(fire.G)
  fire2.load(tmp_path / 'fire')
  for k, v in fire.net.state_dict().items():
    assert torch.equal(fire2.net.state_dict()[k], v)
  assert blob['log_alpha'] == fire2.log_alpha.item()


def test_mesh_raises(tmp_path):
  with pytest.raises(AssertionError, match="unsupported mesh 'tp2'"):
    tmain.main([*RL, f'--logdir={tmp_path}', '--mesh=tp2', 'ppo'])
  with pytest.raises(AssertionError,
                     match='num_envs 4 must divide over 3 devices'):
    tmain.main([*RL, f'--logdir={tmp_path}', '--mesh=dp3', 'ppo'])
