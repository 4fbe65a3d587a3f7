"""PPO: clipped-ratio policy gradient with GAE (the port of
research/rl/ppo.py).

Same semantics: per-env paths finished on done, 80 pi iters (optional
target-KL stop) + 80 v iters per epoch on `bs`-sized minibatches. Two Adam
optimizers, pi over the actor's parameters and v over the critic's: JAX
keeps two optax states over the whole tree, where the other half's
gradients are zero and so never move it.

An epoch's rollout runs on the device in one of three ways:
  - fused real env (`_run_fused_epoch`): a loop over `VecEnv._core_step` on
    device tensors; the (T, B) trajectory is stacked on the device and
    copied to the host once an epoch;
  - fused learned env (`_run_fused_lenv_epoch`): JAX's scanned dream epoch
    step for step (`lenv_rollout`): per-epoch prompt and goal pools from
    real resets, the model's `onestep`, the window slide, the lockstep
    timeout and per-row goal resampling;
  - the unfused loop over `env.step` (preproc, cube-goal learned envs,
    --fused_rollout=0).
Every draw (action normals, onestep uniforms, pool indices, the pools)
can be handed in, so a test can feed JAX's. `--mesh` is not ported and
raises. Checkpoints are the port's own: state dicts and optimizer states
in a pickle, under JAX's file names.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.nets._base import _to_cpu, write_atomic
from boxlcd_tpu_torch.research.rl._base import RLAlgo, to_numpy
from boxlcd_tpu_torch.research.rl.buffers import PPOBuffer
from boxlcd_tpu_torch.research.rl.nets import PPOActorCritic, gaussian_logp


def adam(params, lr):
  """optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root."""
  return torch.optim.Adam(params, lr=float(lr), betas=(0.9, 0.999), eps=1e-8)


def pool_size(B):
  """Real-env snapshots drawn per dream epoch (JAX: ppo.py:236)."""
  return max(4 * B, 256)


def _stack(steps):
  """A list of per-step tuples (dicts of tensors allowed) -> the same
  structure stacked on a new leading time axis, as numpy arrays: one copy
  to the host."""
  out = []
  for field in zip(*steps):
    if isinstance(field[0], dict):
      out.append({k: to_numpy(torch.stack([f[k] for f in field]))
                  for k in field[0]})
    else:
      out.append(to_numpy(torch.stack(field)))
  return tuple(out)


class PPO(RLAlgo):
  def __init__(self, G):
    if str(G.get('mesh', '') or ''):
      raise NotImplementedError(f'--mesh={G.mesh}: sharding is not ported')
    super().__init__(G)
    obs_space = self.obs_space
    act_dim = self.act_space.shape[-1]
    state_size = obs_space[G.state_key].shape[-1]
    goal_size = obs_space[self.goal_key].shape[-1]
    # the same seed gives the same initial weights on every device
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(int(G.seed))
      self.ac = PPOActorCritic(act_dim, G.state_key, self.goal_key,
                               state_size, goal_size, G.hidden_size)
    self.ac.to(self.device)
    self.gen = torch.Generator(device=self.device).manual_seed(int(G.seed))
    self.rng = np.random.RandomState(G.seed)   # minibatch indices
    self.pi_opt = adam(self.ac.pi.parameters(), G.pi_lr)
    self.v_opt = adam(self.ac.v.parameters(), G.vf_lr)

    obs_shapes = {G.state_key: obs_space[G.state_key].shape[-1:],
                  self.goal_key: obs_space[self.goal_key].shape[-1:]}
    self.steps_per_epoch = G.steps_per_epoch // G.num_envs
    self.buf = PPOBuffer(obs_shapes, act_dim, G.num_envs,
                         self.steps_per_epoch, G.gamma, G.lam)
    self._lenv_state = None

  # -- losses and updates (JAX: ppo.py:81-107) --------------------------------
  def _normals(self, shape, eps=None):
    if eps is not None:
      return eps
    return torch.randn(shape, generator=self.gen, device=self.device)

  def _pi_loss(self, batch):
    G = self.G
    mu, std = self.ac.policy(batch['obs'])
    logp = gaussian_logp(mu, std, batch['act'])
    ratio = torch.exp(logp - batch['logp'])
    clip_adv = torch.clamp(ratio, 1 - G.clip_ratio, 1 + G.clip_ratio) \
        * batch['adv']
    loss = -torch.minimum(ratio * batch['adv'], clip_adv).mean()
    kl = (batch['logp'] - logp).mean()
    ent = (0.5 * (1 + np.log(2 * np.pi)) + torch.log(std)).sum(-1).mean()
    return loss, kl, ent

  def _v_loss(self, batch):
    v = self.ac.value(batch['obs'])
    return ((v - batch['ret']) ** 2).mean()

  def _pi_update(self, batch):
    """One Adam step of the policy; returns (loss, kl, entropy) tensors."""
    self.pi_opt.zero_grad(set_to_none=False)
    loss, kl, ent = self._pi_loss(batch)
    loss.backward()
    self.pi_opt.step()
    return loss.detach(), kl.detach(), ent.detach()

  def _v_update(self, batch):
    """One Adam step of the value function; returns its loss."""
    self.v_opt.zero_grad(set_to_none=False)
    loss = self._v_loss(batch)
    loss.backward()
    self.v_opt.step()
    return loss.detach()

  @torch.no_grad()
  def _step(self, obs, eps=None):
    """(action, value, logp) of a batch of net observations."""
    mu, std = self.ac.policy(obs)
    a = mu + std * self._normals(mu.shape, eps)
    return a, self.ac.value(obs), gaussian_logp(mu, std, a)

  def _obs_subset(self, o):
    G = self.G
    return {k: torch.as_tensor(o[k], device=self.device).float()
            for k in (G.state_key, self.goal_key)}

  def get_av(self, o, eps=None):
    return self._step(self._obs_subset(o), eps)

  @torch.no_grad()
  def get_a(self, o, deterministic=False, eps=None):
    mu, std = self.ac.policy(self._obs_subset(o))
    return mu if deterministic else mu + std * self._normals(mu.shape, eps)

  def update(self):
    """80 pi iters + 80 v iters on G.bs random minibatches (reference:
    ppo.py:71-105 — the reference samples `bs`-sized minibatches from the
    whole epoch buffer and has its KL early stop commented out; --kl_stop=1
    re-enables the spinup-style stop). Minibatch indices come from
    self.rng (seeded from G.seed)."""
    G = self.G
    data = self.buf.get()
    dev = self.device
    batch = {'obs': {k: torch.as_tensor(v, device=dev)
                     for k, v in data['obs'].items()},
             **{k: torch.as_tensor(data[k], device=dev)
                for k in ('act', 'ret', 'adv', 'logp')}}
    nbuf = int(batch['act'].shape[0])
    bs = min(int(G.bs), nbuf)

    def mb():
      if bs >= nbuf:
        return batch
      idx = torch.as_tensor(self.rng.randint(0, nbuf, bs), device=dev)
      return {'obs': {k: v[idx] for k, v in batch['obs'].items()},
              **{k: batch[k][idx] for k in ('act', 'ret', 'adv', 'logp')}}
    kl_stop = bool(G.get('kl_stop', 0))
    for i in range(G.train_pi_iters):
      loss, kl, ent = self._pi_update(mb())
      if kl_stop and float(kl) > 1.5 * G.target_kl:
        break
    self.logger['loss/pi'] = loss
    self.logger['kl'] = kl
    self.logger['entropy'] = ent
    self.logger['stop_iter'] = i
    for _ in range(G.train_v_iters):
      vloss = self._v_update(mb())
    self.logger['loss/v'] = vloss

  # -- checkpoints ------------------------------------------------------------
  def save(self, direc, name='ppo.pkl'):
    """Checkpoint actor-critic + optimizer states + generator states + G
    (reference: pponets.py:117-130), written atomically."""
    direc = Path(direc)
    direc.mkdir(parents=True, exist_ok=True)
    write_atomic(direc / name, {
        'ac': _to_cpu(self.ac.state_dict()),
        'pi_opt': _to_cpu(self.pi_opt.state_dict()),
        'v_opt': _to_cpu(self.v_opt.state_dict()),
        'gen_state': self.gen.get_state(), 'rng_state': self.rng.get_state(),
        'G': dict(self.G), 'epoch': int(getattr(self, '_epoch', 0)),
        'best_succ': float(getattr(self, '_best_succ', -1.0))})
    print('SAVED PPO', direc / name)

  def load(self, direc, name='ppo.pkl'):
    with open(Path(direc) / name, 'rb') as f:
      blob = pickle.load(f)
    self.ac.load_state_dict(blob['ac'])
    self.pi_opt.load_state_dict(blob['pi_opt'])
    self.v_opt.load_state_dict(blob['v_opt'])
    self.gen.set_state(blob['gen_state'])
    self.rng.set_state(blob['rng_state'])
    self._start_epoch = int(blob.get('epoch', 0)) + 1
    self._best_succ = float(blob.get('best_succ', -1.0))
    print('LOADED PPO', Path(direc) / name,
          f'(resume at epoch {self._start_epoch})')

  # -- the fused real-env epoch (JAX: ppo.py:150-213) -------------------------
  def _net_obs(self, obs, goals):
    """The policy's observation of a VecEnv batch (device tensors)."""
    venv = self.env
    d = {self.G.state_key: obs[self.G.state_key]}
    if venv.goal_mode == 'cube':
      d[self.goal_key] = goals['full_state'][:, venv._gidx]
    else:
      d[self.goal_key] = goals['proprio']
    return d

  @torch.no_grad()
  def rollout(self, states, goals, steps, eps=None):
    """`steps` steps of policy + VecEnv._core_step on the device (autoreset
    and goal resampling with the VecEnv's generator). Returns (states,
    goals, traj, last_v), traj = (o, a, rew, v, logp, done, success) as
    (T, B, ...) numpy arrays copied to the host once. eps (T, B, act):
    the action normals, drawn from self.gen unless given."""
    venv = self.env
    o = self._net_obs(Env.observe(venv.env, states), goals)
    traj = []
    for t in range(steps):
      a, v, logp = self._step(o, None if eps is None else eps[t])
      states, goals, obs, rew, done, _, success, _ = venv._core_step(
          states, goals, a, venv.gen)
      traj.append((o, a, rew, v, logp, done, success))
      o = self._net_obs(obs, goals)
    return states, goals, _stack(traj), to_numpy(self.ac.value(o))

  def _run_fused_epoch(self, ep_ret, ep_len):
    """Collect one epoch on the device and feed the host GAE buffer."""
    if self.env.states is None:
      self.env.reset()
    self.env.states, self.env.goals, traj, last_v = self.rollout(
        self.env.states, self.env.goals, self.steps_per_epoch)
    return self._store_traj(traj, last_v, ep_ret, ep_len)

  # -- the fused learned-env epoch (JAX: ppo.py:215-348) ----------------------
  def sample_pools(self):
    """The epoch's prompt and goal pools: pool_size(B) observations of
    fresh real resets each (one lcd raster launch each on the card)."""
    raw = self.env.lenv.raw_env
    n = pool_size(self.env.lenv.num_envs)

    def sample():
      o = Env.observe(raw, Env.reset(raw, self.gen, n))
      return {'lcd': o['lcd'].float(), 'proprio': o['proprio']}
    return sample(), sample()

  def _fresh_wb(self, prompts):
    lenv = self.env.lenv
    raw, B, W = lenv.raw_env, lenv.num_envs, lenv.window
    dev = self.device
    wb = {'lcd': torch.zeros((B, W, *raw.observation_space['lcd'].shape),
                             device=dev),
          'proprio': torch.zeros((B, W, max(1, raw.pobs_size)), device=dev),
          'action': torch.zeros((B, W, raw.act_size), device=dev)}
    for k in ('lcd', 'proprio'):
      wb[k][:, 0] = prompts[k].float()
    return wb

  @torch.no_grad()
  def lenv_rollout(self, wb, ptr, ep_t, goals, steps, draws=None):
    """`steps` dream steps: JAX's scanned rollout (ppo.py:250-339), step
    for step. wb: the window batch (B, W, ...) on the device; ptr, ep_t:
    the window pointer and the episode clock, the same for every row (the
    timeout is lockstep); goals: {'goal:lcd', 'goal:proprio'}.

    Each step: the policy reads proprio at ptr - 1, its action is written
    there, the model's `onestep` predicts frame ptr, the window slides at
    W - 1, the body-goal reward is scored, a timeout resets every row from
    the prompt pool, and rows that reached their goal or timed out take a
    goal from the goal pool. `draws` may hold any of: 'prompt_pool' and
    'goal_pool' ({'lcd', 'proprio'}, POOL rows), 'eps' (T, B, act), 'u'
    (T, B, z) the onestep uniforms, 'pidx' and 'gidx' (T, B) pool
    indices; the rest is drawn from self.gen. Returns (wb, ptr, ep_t,
    goals, traj, last_v), traj as in `rollout`."""
    G = self.G
    renv = self.env
    lenv = renv.lenv
    model, W, B = lenv.model, lenv.window, lenv.num_envs
    bidx = renv._bidx
    temp = float(G.get('lenv_temp', 1.0))
    ep_len = int(G.ep_len)
    dev = self.device
    draws = dict(draws or {})
    if 'prompt_pool' not in draws or 'goal_pool' not in draws:
      draws['prompt_pool'], draws['goal_pool'] = self.sample_pools()
    prompt_pool, goal_pool = draws['prompt_pool'], draws['goal_pool']
    POOL = prompt_pool['lcd'].shape[0]
    drawn = lambda k, t: None if k not in draws else draws[k][t]

    def index(k, t):
      i = drawn(k, t)
      if i is None:
        return torch.randint(0, POOL, (B,), generator=self.gen, device=dev)
      return i

    def net_obs(wb, ptr, goals):
      return {G.state_key: wb['proprio'][:, ptr - 1],
              self.goal_key: goals['goal:proprio']}

    traj = []
    for t in range(steps):
      o = net_obs(wb, ptr, goals)
      a, v, logp = self._step(o, drawn('eps', t))
      # LearnedEnv.step
      wb = dict(wb, action=wb['action'].clone())
      wb['action'][:, ptr - 1] = a
      wb = model.onestep(wb, ptr, self.gen, temp, u=drawn('u', t))
      npro = wb['proprio'][:, ptr]
      ptr = min(ptr + 1, W - 1)
      if ptr == W - 1:
        wb = {k: torch.cat([v_[:, 1:], torch.zeros_like(v_[:, :1])], 1)
              for k, v_ in wb.items()}
        ptr -= 1
      ep_t += 1
      timeout = ep_t >= ep_len                          # lockstep
      # RewardLenv's body-goal reward
      delta = (goals['goal:proprio'][:, bidx] - npro[:, bidx]).abs().mean(-1)
      goal_done = delta < G.goal_thresh
      tvec = torch.full((B,), timeout, device=dev)
      success = goal_done & ~tvec
      rew = (-delta + success) * G.rew_scale
      done = tvec | goal_done
      # autoreset: every row from the prompt pool on the (lockstep)
      # timeout; a new goal where a row reached its goal or timed out
      if timeout:
        pidx = index('pidx', t)
        wb = self._fresh_wb({k: v_[pidx] for k, v_ in prompt_pool.items()})
        ptr, ep_t = 1, 0
      gidx = index('gidx', t)
      gmask = done
      goals = {k: torch.where(gmask.view(B, *([1] * (g.dim() - 1))),
                              goal_pool[k.split(':')[1]][gidx], g)
               for k, g in goals.items()}
      traj.append((o, a, rew, v, logp, done, success))
    last_v = to_numpy(self.ac.value(net_obs(wb, ptr, goals)))
    return wb, ptr, ep_t, goals, _stack(traj), last_v

  def _run_fused_lenv_epoch(self, ep_ret, ep_len_acc):
    """Collect one dream epoch on the device and feed the host GAE
    buffer."""
    if self._lenv_state is None:
      self.env.reset()                      # stateful init for parity
      lenv = self.env.lenv
      self._lenv_state = (lenv.window_batch, lenv.ptr, lenv.ep_t,
                          dict(self.env.goal))
    wb, ptr, ep_t, goals = self._lenv_state
    wb, ptr, ep_t, goals, traj, last_v = self.lenv_rollout(
        wb, ptr, ep_t, goals, self.steps_per_epoch)
    self._lenv_state = (wb, ptr, ep_t, goals)
    return self._store_traj(traj, last_v, ep_ret, ep_len_acc)

  def _store_traj(self, traj, last_v, ep_ret, ep_len):
    """Feed a (T, B) trajectory (numpy) into the host GAE buffer."""
    G = self.G
    o_t, a_t, rew_t, v_t, logp_t, done_t, succ_t = traj
    T = self.steps_per_epoch
    for t in range(T):
      self.buf.store_n({k2: v[t] for k2, v in o_t.items()},
                       a_t[t], rew_t[t], v_t[t], logp_t[t])
      ep_ret += rew_t[t]
      ep_len += 1
      epoch_end = t == T - 1
      for i in range(G.num_envs):
        if done_t[t][i] or epoch_end:
          timeout = ep_len[i] >= G.ep_len
          if done_t[t][i]:
            self.logger['EpRet'] = ep_ret[i]
            self.logger['EpLen'] = ep_len[i]
            self.logger['success_rate'] = float(succ_t[t][i])
            ep_ret[i] = 0
            ep_len[i] = 0
          # bootstrap rule (reference ppo.py:160-173): zero the value only at
          # TRUE terminals (success); timeouts and epoch cuts bootstrap with
          # V(next obs) — for an autoreset venv that next obs is the fresh
          # episode's first state, exactly as the reference's step(o) sees it
          if done_t[t][i] and not timeout:
            last_val = 0.0
          elif t == T - 1:
            last_val = float(last_v[i])
          else:
            last_val = float(v_t[t + 1][i])
          self.buf.finish_path(i, last_val)
    return ep_ret, ep_len

  # -- the training loop ------------------------------------------------------
  def _test_and_save(self, epoch):
    """Real-env test + best-checkpoint-by-success saving: ppo.pkl is the
    best-so-far (what eval_policy loads), ppo_last.pkl the rolling one."""
    G = self.G
    succ = self.test_agent(epoch)
    if G.lenv and bool(G.get('lenv_test', 1)):
      self.test_agent(epoch, use_lenv=True)
    utils.dump_logger(self.logger, self.writer, epoch * G.steps_per_epoch, G)
    if succ >= getattr(self, '_best_succ', -1.0):
      self._best_succ = succ
      self.save(G.logdir)
    self.save(G.logdir, name='ppo_last.pkl')
    return succ

  def _collect_unfused(self, o, ep_ret, ep_len):
    """One epoch through env.step (JAX: ppo.py:484-516); returns the next
    observation."""
    G = self.G
    for t in range(self.steps_per_epoch):
      a, v, logp = self.get_av(o)
      next_o, rew, done, info = self.env.step(self.env_action(a))
      rew, done = to_numpy(rew), to_numpy(done)
      self.buf.store_n({k: to_numpy(val)
                        for k, val in self._obs_subset(o).items()},
                       to_numpy(a), rew, to_numpy(v), to_numpy(logp))
      ep_ret += rew
      ep_len += 1
      o = next_o
      epoch_end = t == self.steps_per_epoch - 1
      for i in range(G.num_envs):
        if done[i] or epoch_end:
          timeout = ep_len[i] >= G.ep_len
          if done[i]:
            self.logger['EpRet'] = ep_ret[i]
            self.logger['EpLen'] = ep_len[i]
            ep_ret[i] = 0
            ep_len[i] = 0
          # reference bootstrap rule (ppo.py:160-173): zero only at TRUE
          # terminals; timeouts and epoch cuts bootstrap with V(next obs)
          if done[i] and not timeout:
            last_val = 0.0
          else:
            _, v_i, _ = self.get_av({k: val[i:i + 1] for k, val in
                                     self._obs_subset(o).items()})
            last_val = float(v_i[0])
          self.buf.finish_path(i, last_val)
    return o

  def run(self):
    G = self.G
    epochs = int(G.total_steps) // G.steps_per_epoch
    fused = (not G.lenv and hasattr(self.env, '_core_step')
             and bool(G.get('fused_rollout', 1)))
    fused_lenv = (G.lenv and bool(G.get('fused_rollout', 1))
                  and self.goal_key == 'goal:proprio'
                  and not G.get('preproc')
                  and hasattr(self.env, 'lenv'))
    o = None if (fused or fused_lenv) else self.env.reset()
    ep_ret = np.zeros(G.num_envs)
    ep_len = np.zeros(G.num_envs)
    # wall-clock-aware convergence stop: --early_stop_succ=S stops training
    # once the REAL-env test success is >= S for --early_stop_n consecutive
    # test cycles (the N=1000 eval_policy protocol remains the headline
    # gate; this only truncates the flat tail of the training curve)
    stop_succ = float(G.get('early_stop_succ', 0.0))
    stop_n = int(G.get('early_stop_n', 4))
    streak = 0
    for epoch in range(getattr(self, '_start_epoch', 0), epochs):
      self._epoch = epoch
      ep_start = time.time()
      if fused:
        ep_ret, ep_len = self._run_fused_epoch(ep_ret, ep_len)
      elif fused_lenv:
        ep_ret, ep_len = self._run_fused_lenv_epoch(ep_ret, ep_len)
      else:
        o = self._collect_unfused(o, ep_ret, ep_len)
      self.update()
      self.logger['dt/epoch'] = time.time() - ep_start
      if epoch % G.test_n == 0:
        succ = self._test_and_save(epoch)
        streak = streak + 1 if (stop_succ and succ >= stop_succ) else 0
        if stop_succ and streak >= stop_n:
          print(f'EARLY STOP: test success >= {stop_succ} for {streak} '
                f'consecutive tests (epoch {epoch})')
          break
    self.save(G.logdir, name='ppo_last.pkl')
