"""The generator for dream traffic: PPO's fused learned-env epoch,
`research.rl.ppo.PPO.lenv_rollout`, called back to back over the world
model of the headline chain (an FBT over a frozen BVAE, served as
RewardLenv(LearnedEnv)), from one seed.

Each call draws the epoch's prompt and goal pools through the program
(`PPO.sample_pools`: real resets, one lcd raster launch each) and hands
`lenv_rollout` the pools with the benchmark's own draws for its `steps`
steps, made on the card in four calls: the action normals, the onestep
uniforms and the pool indices at resets and goal resamples (the epoch
draws the same shapes from its generator step by step when none are
given). The weights of the BVAE, the FBT and the policy are drawn on the
card from the seed.

A traffic file of this kind says:
  steps        dream steps a call (the epoch: steps_per_epoch / num_envs)
  warm_steps   steps of the warm-up call (past a slide and a timeout)
  check        {"steps": steps of each call whose onestep the check
                records, "carry_steps": steps of the call the reference
                runs freely from its start (all of them when absent)}
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import trace


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def draw_weights(module, gen):
  """Every parameter of `module` from one normal draw on its device, in the
  type it is served in: kernels N(0, 1/fan_in), norm scales 1 + N(0,
  0.1^2), biases and position embeddings N(0, 0.02^2), the policy's
  log-std -0.5 + N(0, 0.1^2). Returns the benchmark's own copy, by
  parameter name, after loading it into the module."""
  params = list(module.named_parameters())
  dev = params[0][1].device
  flat = torch.randn(sum(p.numel() for _, p in params), generator=gen,
                     device=dev)
  at, out = 0, {}
  for name, p in params:
    n = flat[at:at + p.numel()].view_as(p)
    at += p.numel()
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'log_std':
      out[name] = -0.5 + 0.1 * n
    elif leaf == 'weight' and p.dim() >= 2:
      out[name] = n / float(p[0].numel()) ** 0.5
    elif leaf == 'weight':
      out[name] = 1.0 + 0.1 * n
    else:
      out[name] = 0.02 * n
  with torch.no_grad():
    for name, p in params:
      p.copy_(out[name])
  return out


class _Recorder:
  """Wraps a model's `onestep`: on the chosen steps of each call it keeps
  the window the step read, its pointer, uniforms and temperature, and the
  frame and proprio the step wrote (the last call's records are kept)."""

  def __init__(self, model, want):
    self.orig = model.onestep
    self.want = set(int(t) for t in want)
    self.count, self.steps = 0, []
    model.onestep = self

  def new_call(self):
    self.count, self.steps = 0, []

  def __call__(self, batch, i, gen, temp=1.0, u=None):
    out = self.orig(batch, i, gen, temp, u=u)
    if self.count in self.want:
      self.steps.append({
          't': self.count, 'i': int(i), 'temp': float(temp),
          'u': u.clone(), 'lcd': batch['lcd'].clone(),
          'proprio': batch['proprio'].clone(),
          'action': batch['action'].clone(),
          'out_lcd': out['lcd'][:, i].clone(),
          'out_proprio': out['proprio'][:, i].clone()})
    self.count += 1
    return out


def config_G(cfg, seed, device):
  """(PPO's G, the BVAE's, the FBT's) from the configuration file, parsed
  by the port's RL entry point as the headline chain's command line."""
  from boxlcd_tpu_torch.research.rl.main import parse
  ppo = cfg['ppo']
  argv = ['ppo', f'--env={cfg["env"]}', f'--device={device}',
          f'--seed={int(seed) % 2 ** 32}', '--lenv=0',
          *[f'--{k}={v}' for k, v in cfg['env_config'].items()],
          *[f'--{k}={v}' for k, v in ppo.items()]]
  G = parse(argv)
  Gb, Gf = type(G)(G), type(G)(G)
  Gb.update(cfg['bvae'])
  Gf.update(cfg['fbt'])
  return G, Gb, Gf


class Cell:
  """One cell of dream traffic on one device."""

  def __init__(self, cfg, traffic, seed, device):
    from boxlcd_tpu_torch.research import utils as rutils
    from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
    from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
    from boxlcd_tpu_torch.research.rl.ppo import PPO
    from boxlcd_tpu_torch.research.wrappers import LearnedEnv, RewardLenv
    self.cfg, self.traffic = cfg, traffic
    self.device = torch.device(device)
    self.seed = int(seed)
    G, Gb, Gf = config_G(cfg, seed, device)
    # no TensorBoard writer: a run writes nothing
    make_writer = rutils.make_writer
    rutils.make_writer = lambda logdir: rutils.NullWriter()
    try:
      self.ppo = PPO(G)
    finally:
      rutils.make_writer = make_writer
    raw = self.ppo.tenv._env
    self.bvae = BVAE(raw, Gb)
    self.fbt = FBT(raw, Gf, bvae=self.bvae)
    self.ppo.env = RewardLenv(LearnedEnv(G.num_envs, self.fbt, G,
                                         real_env=self.ppo.tenv))
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(self.seed)
    self.weights = {k: draw_weights(m, self.gen) for k, m in (
        ('bvae', self.bvae.module), ('fbt', self.fbt.module),
        ('ac', self.ppo.ac))}
    self.B = int(G.num_envs)
    self.A = raw.act_size
    self.Z = self.fbt.z_size
    self.T = int(traffic['steps'])
    rng = np.random.default_rng(abs(self.seed))
    self.want = np.sort(rng.choice(self.T, int(traffic['check']['steps']),
                                   replace=False))
    self.rec = _Recorder(self.fbt, self.want)
    self.state = None
    self.spans = {'call_s': []}
    self.last = self.prof = None

  def _call(self, steps):
    """One lenv_rollout call of `steps` steps from the carried state;
    returns its trajectory on the host."""
    ppo = self.ppo
    if self.state is None:
      ppo.env.reset()
      lenv = ppo.env.lenv
      self.state = (lenv.window_batch, lenv.ptr, lenv.ep_t,
                    dict(ppo.env.goal))
    pool_state = ppo.gen.get_state()
    pp, gp = ppo.sample_pools()
    pool = pp['lcd'].shape[0]
    g, dev, B = self.gen, self.device, self.B
    draws = {'prompt_pool': pp, 'goal_pool': gp,
             'eps': torch.randn((steps, B, self.A), generator=g, device=dev),
             'u': torch.rand((steps, B, self.Z), generator=g, device=dev),
             'pidx': torch.randint(0, pool, (steps, B), generator=g,
                                   device=dev),
             'gidx': torch.randint(0, pool, (steps, B), generator=g,
                                   device=dev)}
    self.rec.new_call()
    start = self.state
    wb, ptr, ep_t, goals, traj, last_v = ppo.lenv_rollout(
        *start, steps, draws)
    self.state = (wb, ptr, ep_t, goals)
    self.last = {'pool_state': pool_state, 'pools': (pp, gp),
                 'start': start, 'draws': draws, 'traj': traj,
                 'steps': list(self.rec.steps)}
    return traj

  def warm(self):
    """One short call: past a window slide and a timeout, at this cell's
    shapes."""
    self._call(int(self.traffic['warm_steps']))
    _sync(self.device)

  def window(self, seconds, profile=False):
    """Calls back to back until `seconds` have passed; the window closes at
    the end of the call that crosses it. Returns (attempted env-steps,
    failed, env-steps completed, window seconds)."""
    calls = 0
    _sync(self.device)
    with trace.profiler(profile, self.device) as prof:
      t0 = time.perf_counter()
      while True:
        c0 = time.perf_counter()
        self._call(self.T)          # ends on the host copy of its traj
        self.spans['call_s'].append(time.perf_counter() - c0)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
          break
      _sync(self.device)
      wall = time.perf_counter() - t0
    self.prof = prof
    self.calls = calls
    steps = calls * self.T * self.B
    return steps, 0, steps, wall

  def readings(self):
    v = self.spans['call_s']
    return {'call_s_min': min(v), 'call_s_max': max(v), 'calls': len(v)}

  def traced(self):
    """The traced window's device activity (the profiler's trace), its
    dream steps, and the shapes the yardstick counts from."""
    out = {'dream_steps': self.calls * self.T, 'yard': self.shapes()}
    if self.prof is not None:
      busy, by, _ = trace.activity(trace.device_events(self.prof))
      out.update(busy_s=busy, kernels=by,
                 kernel_count=sum(c for _, c in by.values()))
    return out

  def shapes(self):
    G, Gb, Gf = self.ppo.G, self.bvae.G, self.fbt.G
    raw = self.ppo.tenv._env
    return {'B': self.B, 'W': int(Gf.window), 'H': raw.lcd_h,
            'Wd': raw.lcd_w, 'P': max(1, raw.pobs_size), 'A': self.A,
            'hidden': int(Gb.hidden_size), 'nfilter': int(Gb.nfilter),
            'vqD': int(Gb.vqD), 'zH': self.bvae.zH, 'zW': self.bvae.zW,
            'n_embed': int(Gf.n_embed), 'n_layer': int(Gf.n_layer),
            'ppo_hidden': int(G.hidden_size)}

  def breakdown(self, rec):
    gaps = [['host: between device operations (launches, syncs, the '
             'host copy of each call)', rec['window_s'] - rec['busy_s']]]
    return {'device_ops': trace.top_ops(rec['kernels']), 'idle_gaps': gaps}

  def answers(self, seed):
    """The window's last call, as delivered: its pools and the generator
    state they were drawn from, the state it started from, its draws and
    trajectory, and the recorded onestep inputs and outputs; the weights
    the benchmark drew."""
    last = self.last
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    steps = [host({k: v for k, v in s.items() if torch.is_tensor(v)})
             | {k: v for k, v in s.items() if not torch.is_tensor(v)}
             for s in last['steps']]
    wb, ptr, ep_t, goals = last['start']
    draws = last['draws']
    return {'ok': True, 'gen_state': last['pool_state'],
            'gen_device': self.device,
            'pools': [host(p) for p in last['pools']],
            'start': {'wb': host(wb), 'ptr': int(ptr), 'ep_t': int(ep_t),
                      'goals': host(goals)},
            'draws': host({k: draws[k] for k in ('eps', 'u', 'pidx',
                                                 'gidx')}),
            'traj': last['traj'], 'steps': steps,
            'weights': {k: host(w) for k, w in self.weights.items()},
            'shapes': self.shapes(), 'state_key': self.ppo.G.state_key,
            'goal_key': self.ppo.goal_key}
