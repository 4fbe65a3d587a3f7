"""The generator for dream traffic over the DeepSeek-V2 world model
(`FBTDSV2`): PPO's fused learned-env epoch, `PPO.lenv_rollout`, called
back to back, as `portbench/drivers/dream.py` drives the FBT, from one
seed. What differs:
- the world model is `FBTDSV2` at the configuration's top-level
  config.json keys (`reference/dsv2.model_config`: the yardstick and the
  check read the same, and the program's module has to hold them), in its
  `world_model.precision`; its weights (30.6 GB
  at DeepSeek-V2-Lite's widths) are drawn on the card parameter by
  parameter (`portbench/reference/dsv2_weights.py`), so the check can draw
  them again without the program;
- the recorder also keeps, on the recorded steps, the window codes the
  transformer read and its logits at the pointer;
- a traced window runs the timed path (the transformer's CUDA graph) with
  the program's tracer on (`boxlcd_tpu_torch.trace`), and `traced()` hands
  over its spans and counters (`program`); a replay shows no per-layer
  spans, so `traced()` then runs `EAGER_CALLS` eager calls of the module on
  the last recorded window under the profiler and the tracer (`eager`:
  their spans, the profiler's events with the driver-API launches by which
  Triton launches, and the calls), for the `dsv2.*` breakdown alone;
- `answers()` holds no world-model weights and frees them on the card.

The traffic file is `dream.py`'s kind; `check.carry_steps` bounds the
steps the float32 reference runs freely (see the traffic file).
"""
from __future__ import annotations

import torch

from portbench import trace
from portbench.drivers import dream
from portbench.metrics import _dsv2
from portbench.reference import dsv2 as ref_dsv2
from portbench.reference import dsv2_weights

EAGER_CALLS = 3


def config_G(cfg, seed, device):
  """(PPO's G, the BVAE's, the world model's) from the configuration
  file: the world model's config.json keys from its top level."""
  G, Gb, _ = dream.config_G(dict(cfg, fbt={}), seed, device)
  Gw = type(G)(G)
  wm = cfg['world_model']
  Gw.update(window=int(wm['window']), dsv2_precision=wm['precision'],
            dsv2=ref_dsv2.model_config(cfg))
  return G, Gb, Gw


class _Recorder(dream._Recorder):
  """dream's recorder, with the codes (B, W, z) the transformer read and
  its logits at the pointer (B, z) on the recorded steps (the model's
  `transformer`, which `onestep` calls, wrapped)."""

  def __init__(self, model, want):
    super().__init__(model, want)
    self.grab = None
    self.transformer = model.transformer
    model.transformer = self._transformer

  def _transformer(self, z, action):
    out = self.transformer(z, action)
    if self.grab is not None:
      # thresholded, not cast: straight-through codes sit within ~1e-7
      # of 0 and 1
      self.grab.update(codes=z > 0.5,
                       logits=out[:, self.grab['i']].float().clone())
    return out

  def __call__(self, batch, i, gen, temp=1.0, u=None):
    self.grab = {'i': int(i)} if self.count in self.want else None
    out = super().__call__(batch, i, gen, temp, u)
    if self.grab is not None:
      self.steps[-1].update(codes=self.grab['codes'],
                            logits=self.grab['logits'])
      self.grab = None
    return out


class Cell(dream.Cell):
  """One cell of dream traffic over FBTDSV2 on one device."""

  def __init__(self, cfg, traffic, seed, device):
    # first: a program without the model stops here, before any work
    from boxlcd_tpu_torch.research.nets.video_models.fbt_dsv2 import FBTDSV2
    from boxlcd_tpu_torch.research import utils as rutils
    from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
    from boxlcd_tpu_torch.research.rl.ppo import PPO
    from boxlcd_tpu_torch.research.wrappers import LearnedEnv, RewardLenv
    import numpy as np
    self.cfg, self.traffic = cfg, traffic
    self.device = torch.device(device)
    self.seed = int(seed)
    G, Gb, Gw = config_G(cfg, seed, device)
    make_writer = rutils.make_writer
    rutils.make_writer = lambda logdir: rutils.NullWriter()
    try:
      self.ppo = PPO(G)
    finally:
      rutils.make_writer = make_writer
    raw = self.ppo.tenv._env
    self.bvae = BVAE(raw, Gb)
    self.fbt = FBTDSV2(raw, Gw, bvae=self.bvae)
    self.ppo.env = RewardLenv(LearnedEnv(G.num_envs, self.fbt, G,
                                         real_env=self.ppo.tenv))
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(self.seed)
    self.weights = {k: dream.draw_weights(m, self.gen) for k, m in (
        ('bvae', self.bvae.module), ('ac', self.ppo.ac))}
    self.model_cfg = ref_dsv2.model_config(cfg)
    self.program_cfg = dict(self.fbt.module.cfg)
    if self.program_cfg != self.model_cfg:
      raise ValueError(f'the program built {self.program_cfg}, the '
                       f'configuration states {self.model_cfg}')
    dsv2_weights.load_into(self.fbt.module, self.seed)
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
    self.last = self.prof = self.program = self.eager = None

  def window(self, seconds, profile=False):
    """dream's window; a profiled one with the program's tracer on."""
    from boxlcd_tpu_torch import trace as tracer
    if profile:
      tracer.start()
    try:
      return super().window(seconds, profile)
    finally:
      if profile:
        self.program = tracer.stop()

  def traced(self):
    out = super().traced()
    out['program'] = self.program
    if self.prof is not None:
      out['eager'] = self.eager_calls()
    return out

  def eager_calls(self, n=EAGER_CALLS):
    """n eager calls of the transformer's module (no graph) on the window
    the last recorded step read, under the profiler and the program's
    tracer: {'program': spans and counters, 'events': the profiler's
    device events and launch calls, 'calls': n}."""
    from boxlcd_tpu_torch import trace as tracer
    x = self.last['steps'][-1]
    z, a = x['codes'].float(), x['action']
    module = self.fbt.module
    with torch.no_grad():
      module(z, a)
      dream._sync(self.device)
      tracer.start()
      try:
        with trace.profiler(True, self.device) as prof:
          for _ in range(n):
            module(z, a)
          dream._sync(self.device)
      finally:
        program = tracer.stop()
    return {'program': program, 'events': _dsv2.profiler_events(prof),
            'calls': n}

  def shapes(self):
    G, Gb = self.ppo.G, self.bvae.G
    raw = self.ppo.tenv._env
    return {'B': self.B, 'W': int(self.fbt.G.window), 'H': raw.lcd_h,
            'Wd': raw.lcd_w, 'P': max(1, raw.pobs_size), 'A': self.A,
            'hidden': int(Gb.hidden_size), 'nfilter': int(Gb.nfilter),
            'vqD': int(Gb.vqD), 'zH': self.bvae.zH, 'zW': self.bvae.zW,
            'ppo_hidden': int(G.hidden_size), 'cfg': self.model_cfg}

  def answers(self, seed):
    """dream's answers (the BVAE's and the policy's weights, no world
    model's), with the recorded codes and logits; the world model's
    weights are then freed on the card for the check."""
    ans = super().answers(seed)
    ans['seed'] = self.seed
    ans['program_cfg'] = self.program_cfg
    # in place: the optimizer and the model's parameter list hold the same
    # Parameter objects, so their storage goes with this
    for p in self.fbt.module.parameters():
      p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    self.fbt._graphs.clear()
    return ans
