"""SAC: twin-Q soft actor-critic with learned temperature (the port of
research/rl/sac.py). FIFO replay, polyak targets, timeout-aware done
masking.

Three Adam optimizers, as JAX's three optax states: q over both Q nets,
pi over the actor, alpha over log_alpha. The q-loss's next action comes
from the target actor; the pi-loss reads the freshly updated Q nets
without differentiating them. `update_burst` is a loop over `update`.
Draws: the actor's normals from self.gen (or handed in as `eps_q` /
`eps_pi`), replay indices from self.rng (np.random.RandomState(G.seed),
JAX's stream), the start-steps' random actions from their own
self.act_rng.
"""
from __future__ import annotations

import copy
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.nets._base import _to_cpu, write_atomic
from boxlcd_tpu_torch.research.rl._base import RLAlgo, to_numpy
from boxlcd_tpu_torch.research.rl.buffers import ReplayBuffer
from boxlcd_tpu_torch.research.rl.nets import SACNets
from boxlcd_tpu_torch.research.rl.ppo import adam

ACT_SEED_OFFSET = 1   # the start-steps' action stream: G.seed + 1


class SAC(RLAlgo):
  def __init__(self, G):
    super().__init__(G)
    obs_space = self.obs_space
    act_dim = self.act_space.shape[-1]
    state_size = obs_space[G.state_key].shape[-1]
    net_kind = str(G.get('net', 'mlp'))
    # which obs keys the net consumes (reference: sacnets.py:31-158)
    self.net_keys = [G.state_key, self.goal_key]
    if net_kind in ('cmlp', 'cnn'):
      self.net_keys += ['lcd', 'goal:lcd']
    elif net_kind == 'bvae':
      self.net_keys += ['zstate', 'goal:zstate']

    def _space_shape(k):
      shp = obs_space[k].shape
      return shp[-2:] if k.endswith('lcd') else shp[-1:]
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(int(G.seed))
      self.net = SACNets(
          act_dim, G.state_key, self.goal_key, state_size,
          obs_space[self.goal_key].shape[-1], G.hidden_size, net=net_kind,
          nfilter=int(G.get('nfilter', 64)), zdelta=bool(G.get('zdelta', 1)),
          lcd_shape=tuple(_space_shape('lcd')),
          z_size=(obs_space['zstate'].shape[-1] if net_kind == 'bvae'
                  else None))
    self.net.to(self.device)
    self.target = copy.deepcopy(self.net).requires_grad_(False)
    self.log_alpha = torch.tensor(float(np.log(G.alpha)), device=self.device,
                                  requires_grad=True)
    self.target_ent = -act_dim
    self.pi_params = list(self.net.pi.parameters())
    self.q_params = [*self.net.q1.parameters(), *self.net.q2.parameters()]
    self.pi_opt = adam(self.pi_params, G.pi_lr)
    self.q_opt = adam(self.q_params, G.vf_lr)
    self.a_opt = adam([self.log_alpha], G.alpha_lr)
    self.gen = torch.Generator(device=self.device).manual_seed(int(G.seed))
    obs_shapes = {k: _space_shape(k) for k in self.net_keys}
    obs_dtypes = {k: (bool if k.endswith('lcd') else np.float32)
                  for k in self.net_keys}
    self.buf = ReplayBuffer(obs_shapes, act_dim, int(G.replay_size),
                            obs_dtypes=obs_dtypes)
    self.rng = np.random.RandomState(G.seed)
    self.act_rng = np.random.RandomState(G.seed + ACT_SEED_OFFSET)

  # -- the update (JAX: sac.py:60-116) ----------------------------------------
  def _normals(self, batch, eps):
    if eps is not None:
      return eps
    return torch.randn((batch['act'].shape[0], batch['act'].shape[-1]),
                       generator=self.gen, device=self.device)

  def update(self, batch, eps_q=None, eps_pi=None):
    """One SAC update on a batch (tensors on the device): the twin-Q step,
    the actor step, the temperature step (G.learned_alpha) and the polyak
    targets. eps_q: the target actor's normals at obs2, eps_pi: the
    actor's at obs, each (bs, act), drawn from self.gen (in that order)
    unless given. Returns the metrics as detached tensors."""
    G = self.G
    net, target = self.net, self.target
    eps_q = self._normals(batch, eps_q)
    eps_pi = self._normals(batch, eps_pi)
    alpha = torch.exp(self.log_alpha.detach())
    # q: the backup's next action comes from the target actor
    q1, q2 = net.qs(batch['obs'], batch['act'])
    with torch.no_grad():
      a2, logp2 = target.actor(batch['obs2'], eps=eps_q)
      tq1, tq2 = target.qs(batch['obs2'], a2)
      done = batch['done'] if G.use_done else torch.zeros_like(batch['done'])
      backup = batch['rew'] + G.gamma * (1 - done) * (
          torch.minimum(tq1, tq2) - alpha * logp2)
    ql = ((q1 - backup) ** 2).mean() + ((q2 - backup) ** 2).mean()
    self.q_opt.zero_grad(set_to_none=False)
    ql.backward()
    self.q_opt.step()
    # pi: through the updated Q nets, which it does not differentiate
    a, logp = net.actor(batch['obs'], eps=eps_pi)
    qa1, qa2 = net.qs(batch['obs'], a)
    pl = (alpha * logp - torch.minimum(qa1, qa2)).mean()
    for p, g in zip(self.pi_params, torch.autograd.grad(pl, self.pi_params)):
      p.grad = g
    self.pi_opt.step()
    logp = logp.detach()
    if G.learned_alpha:
      al = -(torch.exp(self.log_alpha) * (logp + self.target_ent)).mean()
      self.a_opt.zero_grad(set_to_none=False)
      al.backward()
      self.a_opt.step()
      al = al.detach()
    else:
      al = torch.zeros((), device=self.device)
    with torch.no_grad():
      tp, p = list(target.parameters()), list(net.parameters())
      torch._foreach_mul_(tp, G.polyak)
      torch._foreach_add_(tp, p, alpha=1 - G.polyak)
    return {'loss/q': ql.detach(), 'loss/pi': pl.detach(), 'loss/alpha': al,
            'q1': q1.detach().mean(), 'q2': q2.detach().mean(),
            'alpha': torch.exp(self.log_alpha.detach()),
            'logp': logp.mean()}

  def update_burst(self, batches, eps_q=None, eps_pi=None):
    """The reference's inner `for j in range(update_every)` loop
    (reference: research/rl/sac.py update block): `update` on each of the
    n batches (leading axis n) in turn; returns the last metrics."""
    n = batches['rew'].shape[0]
    for i in range(n):
      batch = {k: ({kk: vv[i] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[i])
               for k, v in batches.items()}
      metrics = self.update(batch, None if eps_q is None else eps_q[i],
                            None if eps_pi is None else eps_pi[i])
    return metrics

  def _obs_subset(self, o):
    return {k: torch.as_tensor(o[k], device=self.device).float()
            for k in self.net_keys}

  def _host_obs(self, o):
    return {k: to_numpy(o[k]).astype(np.float32) for k in self.net_keys}

  # -- checkpoints ------------------------------------------------------------
  def save(self, direc):
    """Checkpoint policy/Q nets, targets, temperature, optimizer and
    generator states + G (reference: sac.py:337-338), written
    atomically."""
    direc = Path(direc)
    direc.mkdir(parents=True, exist_ok=True)
    write_atomic(direc / 'sac.pkl', {
        'net': _to_cpu(self.net.state_dict()),
        'target': _to_cpu(self.target.state_dict()),
        'log_alpha': self.log_alpha.item(),
        'pi_opt': _to_cpu(self.pi_opt.state_dict()),
        'q_opt': _to_cpu(self.q_opt.state_dict()),
        'a_opt': _to_cpu(self.a_opt.state_dict()),
        'gen_state': self.gen.get_state(), 'G': dict(self.G)})
    print('SAVED SAC', direc / 'sac.pkl')

  def load(self, direc):
    with open(Path(direc) / 'sac.pkl', 'rb') as f:
      blob = pickle.load(f)
    self.net.load_state_dict(blob['net'])
    self.target.load_state_dict(blob['target'])
    with torch.no_grad():
      self.log_alpha.fill_(blob['log_alpha'])
    self.pi_opt.load_state_dict(blob['pi_opt'])
    self.q_opt.load_state_dict(blob['q_opt'])
    self.a_opt.load_state_dict(blob['a_opt'])
    self.gen.set_state(blob['gen_state'])
    print('LOADED SAC', Path(direc) / 'sac.pkl')

  @torch.no_grad()
  def get_a(self, o, deterministic=False, eps=None):
    a, _ = self.net.actor(self._obs_subset(o), self.gen, deterministic,
                          eps=eps)
    return a

  # -- the loops --------------------------------------------------------------
  def _log_metrics(self, metrics):
    self.logger.update({k: float(v) for k, v in metrics.items()})

  def run_firehose(self):
    """On-policy firehose variant (reference: sac.py:200-240): no replay
    buffer — every iteration steps the big batched env with the current
    policy and SAC-updates on that fresh transition batch directly. Suited
    to the learned env, whose observations stay on the device."""
    G = self.G
    o = self.env.reset()
    t0 = time.time()
    dev = self.device
    for itr in range(1, int(G.total_steps) + 1):
      a = self.get_a(o)
      o2, rew, done, info = self.env.step(self.env_action(a))
      batch = {'obs': self._obs_subset(o), 'act': a,
               'rew': torch.as_tensor(rew, device=dev).float().reshape(-1),
               'obs2': self._obs_subset(o2),
               'done': torch.as_tensor(done, device=dev).float().reshape(-1)}
      metrics = self.update(batch)
      o = o2
      if itr % 200 == 0:  # periodic hard reset (reference: sac.py:214-215)
        o = self.env.reset()
      if itr % max(1, G.log_n // 10) == 0:
        self._log_metrics(metrics)
        self.test_agent(itr)
        if G.lenv:
          self.test_agent(itr, use_lenv=True)
        self.logger['fps'] = itr * G.num_envs / (time.time() - t0)
        utils.dump_logger(self.logger, self.writer, itr, G)
        self.save(G.logdir)

  def run(self):
    G = self.G
    o = self.env.reset()
    ep_ret = np.zeros(G.num_envs)
    ep_len = np.zeros(G.num_envs)
    t0 = time.time()
    dev = self.device
    for t in range(0, int(G.total_steps), G.num_envs):
      if t < G.start_steps:
        a = self.act_rng.uniform(-1, 1, (G.num_envs,
                                         self.act_space.shape[-1]))
        a = a.astype(np.float32)
      else:
        a = to_numpy(self.get_a(o))
      o2, rew, done, info = self.env.step(
          torch.as_tensor(a, device=dev) if G.lenv else a)
      rew, done = to_numpy(rew), to_numpy(done)
      if isinstance(info, list):
        timeout = np.array([i['timeout'] for i in info])
      else:
        timeout = to_numpy(info['timeout'])
      store_done = done & ~timeout  # timeout is not a true terminal
      self.buf.store_n(self._host_obs(o), a, rew, self._host_obs(o2),
                       store_done.astype(np.float32))
      ep_ret += rew
      ep_len += 1
      for i in np.nonzero(done)[0]:
        self.logger['EpRet'] = ep_ret[i]
        self.logger['EpLen'] = ep_len[i]
        ep_ret[i] = 0
        ep_len[i] = 0
      o = o2
      if t >= G.update_after and (t // G.num_envs) % \
          max(1, G.update_every // G.num_envs) == 0:
        # one burst for the whole update_every block; i.i.d. batches are
        # sampled in one host draw
        n = int(G.update_every)
        big = self.buf.sample_batch(self.rng, n * G.bs)
        to_dev = lambda v: torch.as_tensor(v, device=dev).reshape(
            n, G.bs, *v.shape[1:])
        batches = {k: ({kk: to_dev(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else to_dev(v))
                   for k, v in big.items()}
        self._log_metrics(self.update_burst(batches))
      if (t // G.num_envs) % max(1, 4000 // G.num_envs) == 0 and t > 0:
        self.test_agent(t)
        if G.lenv:
          self.test_agent(t, use_lenv=True)
        self.logger['fps'] = t / (time.time() - t0)
        utils.dump_logger(self.logger, self.writer, t, G)
        self.save(G.logdir)
