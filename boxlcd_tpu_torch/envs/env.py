"""WorldEnv: declarative world -> batched functional env in torch (+ gym shell).

The functional core mirrors boxlcd_tpu's Env (itself the re-architecture of
the reference's WorldEnv, boxLCD/world_env.py:21-535): `reset`/`step`/
`observe` work on a WorldState whose tensors carry a leading worlds axis, so
thousands of worlds step together on the card.

A thin stateful wrapper provides the reference's single-env gym API
(reset(full_state=|proprio=)/step/render and obs/action spaces) on a batch
of one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boxlcd_tpu_torch import spaces, utils
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.engine.collision import rot_apply
from boxlcd_tpu_torch.engine.spec import (
    KCOS_REL, KX_REL, RANDOM, ROLE_OBJECT, ROLE_ROOT, compile_world)
from boxlcd_tpu_torch.render import raster


def wrap_angle(a):
  return torch.atan2(torch.sin(a), torch.cos(a))


class _Pose(NamedTuple):
  """The subset of WorldState that observations depend on."""
  is_circle: torch.Tensor
  c: torch.Tensor
  a: torch.Tensor


class Env:
  """Functional env core compiled from a WorldDef, on one device."""

  # defaults mirror the reference env config (boxLCD/world_env.py:32-45)
  ENV_DG = utils.AttrDict(
      base_dim=5, lcd_base=16, wh_ratio=2.0, ep_len=100,
      angular_offset=0, root_offset=0, compact_obs=0, use_speed=1,
      all_corners=0, walls=1, debug=0, fps=10)

  def __init__(self, world_def, G=None, device=None):
    self.device = utils.resolve_device(device)
    self.world_def = world_def
    self.G = utils.AttrDict(self.ENV_DG)
    if G:
      if not isinstance(G, dict):
        G = G.__dict__
      for k in G:
        self.G[k] = G[k]
    self.spec = compile_world(world_def, self.G)
    self.lcd_h = int(self.G.lcd_base)
    self.lcd_w = int(self.G.lcd_base * self.G.wh_ratio)
    s = self.spec
    self.obs_info = utils.sortdict(
        {k: s.obs_bounds[i] for i, k in enumerate(s.obs_keys)})
    self.act_info = utils.sortdict({k: np.array([-1.0, 1.0]) for k in s.act_keys}
                                   or {'dummy': np.array([-1.0, 1.0])})
    self.obs_keys = list(s.obs_keys)
    self.obs_size = len(self.obs_keys)
    self.pobs_keys = list(s.pobs_keys)
    self.pobs_size = len(self.pobs_keys)
    self.pobs_idxs = list(np.asarray(s.pobs_idxs))
    self.act_keys = list(self.act_info.keys())
    self.act_size = len(self.act_keys)
    self.observation_space = spaces.Dict({
        'full_state': spaces.Box(-1, 1, (self.obs_size,), np.float32),
        'proprio': spaces.Box(-1, 1, (max(1, self.pobs_size),), np.float32),
        'lcd': spaces.Box(0, 1, (self.lcd_h, self.lcd_w), bool),
    })
    self.action_space = spaces.Box(-1, 1, (self.act_size,), np.float32)
    # static per-body joint lookup for spawn placement
    self._child_joint = {int(s.j_child[j]): j for j in range(s.jn)}
    dev = self.device
    t = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt), device=dev)
    self._obs_lo = t(s.obs_bounds[:, 0], np.float32)
    self._obs_hi = t(s.obs_bounds[:, 1], np.float32)
    self._obs_body = t(s.obs_body, np.int64)
    self._obs_kind = t(s.obs_kind, np.int64)
    self._pobs_idxs = t(s.pobs_idxs, np.int64)
    self._root = t(s.root_of, np.int64)
    self._b_idx = [t(x, np.int64) for x in (s.b_xi, s.b_yi, s.b_ci, s.b_si)]
    self._rel_pos = t(s.obs_kind[s.b_xi] == KX_REL)
    self._rel_ang = t(s.obs_kind[s.b_ci] == KCOS_REL)

  # ---- functional API (a leading worlds axis everywhere) ---------------------

  def reset(self, gen: torch.Generator, batch: int) -> physics.WorldState:
    """Sample `batch` fresh episode states (reference: world_env.py:197-304).

    Per body, four uniforms in [0, 1) play the roles of boxlcd_tpu's four
    per-body keys (x, y, and the two angle samples); as there, the RANDOM
    shape coin reuses the fourth draw (jax.random.bernoulli on the key of
    the second angle sample)."""
    s = self.spec
    dev = self.device
    st = physics.init_state(s, batch, dev)
    n = s.n
    u01 = torch.rand((batch, n, 4), generator=gen, device=dev)
    uni = lambda u, lo, hi: torch.clamp(u * (hi - lo) + lo, min=lo)
    origin = torch.zeros((batch, n, 2), device=dev)
    angle = torch.zeros((batch, n), device=dev)
    is_circle = st.is_circle.clone()
    for i in range(n):  # creation order puts parents first
      role = int(s.role[i])
      if role in (ROLE_ROOT, ROLE_OBJECT):
        rx = float(s.rs_rangex[i])
        x = utils.mapto(uni(u01[:, i, 0], -rx, rx), (0.0, s.width))
        lo, hi = float(s.rs_rangey_lo[i]), float(s.rs_rangey_hi[i])
        uy = (uni(u01[:, i, 1], lo, hi) if hi > lo
              else torch.full((batch,), lo, device=dev))
        y = utils.mapto(uy, (0.0, s.height))
        # angle from independent sin/cos samples (world_env.py:213,292)
        if s.rs_rand_angle[i]:
          angle[:, i] = torch.atan2(uni(u01[:, i, 2], -1.0, 1.0),
                                    uni(u01[:, i, 3], -1.0, 1.0))
        origin[:, i, 0] = x
        origin[:, i, 1] = y
        if role == ROLE_OBJECT and int(s.shape_static[i]) == RANDOM:
          is_circle[:, i] = u01[:, i, 3] < 0.5     # box|circle coin flip
      else:  # ROLE_CHILD: placed from parent via joint anchors
        j = self._child_joint[i]
        root = int(s.root_of[i])
        parent = int(s.parent_of[i])
        mangle = wrap_angle(angle[:, root] + float(s.j_angle0[j]))
        pangle = angle[:, parent]  # parent's own (already composed) angle
        anc_a = torch.as_tensor(s.j_anchor_a[j], device=dev)
        anc_b = torch.as_tensor(s.j_anchor_b[j], device=dev)
        aa = rot_apply(torch.cos(pangle)[:, None], torch.sin(pangle)[:, None],
                       anc_a[None])[:, 0]
        ab = rot_apply(torch.cos(mangle)[:, None], torch.sin(mangle)[:, None],
                       anc_b[None])[:, 0]
        origin[:, i] = origin[:, parent] + aa - ab
        angle[:, i] = mangle
    c = physics.com_from_origin(s, is_circle, origin, angle)
    # joint reference angles: pybox2d initializes referenceAngle to the spawn
    # relative angle when bodyA/bodyB are passed to revoluteJointDef
    K = physics.consts(s, dev)
    j_ref = (angle[:, K.j_ch] - angle[:, K.j_pa]) * K.j_validf
    return st._replace(c=c, a=angle, is_circle=is_circle, j_ref=j_ref)

  def teleport(self, gen: torch.Generator, full_state=None, proprio=None
               ) -> physics.WorldState:
    """Reset then overwrite poses from (B, obs) normalized state vectors, or
    from (B, pobs) proprio vectors (other entries zero).

    This is the reference's state-injection API (world_env.py:319-380), used
    to re-render model predictions and to set goals. Velocities stay zero.
    """
    if proprio is not None:
      proprio = torch.as_tensor(proprio, dtype=torch.float32,
                                device=self.device)
      full = torch.zeros((proprio.shape[0], self.obs_size), device=self.device)
      full[:, self._pobs_idxs] = proprio
    else:
      full = torch.as_tensor(full_state, dtype=torch.float32,
                             device=self.device)
    # call the functional reset explicitly: WorldEnv overrides self.reset
    # with the stateful gym-style signature
    st = Env.reset(self, gen, full.shape[0])
    vals = utils.mapto(full, (self._obs_lo, self._obs_hi))
    x, y, cos, sin = (vals[:, i] for i in self._b_idx)
    origin = torch.stack([x, y], -1)
    angle = torch.atan2(sin, cos)
    # undo root-relative encodings (reference: world_env.py:369, 377-379)
    origin = torch.where(self._rel_pos[:, None], origin + origin[:, self._root],
                         origin)
    comb = wrap_angle(angle + angle[:, self._root])
    angle = torch.where(self._rel_ang, comb, angle)
    c = physics.com_from_origin(self.spec, st.is_circle, origin, angle)
    return st._replace(c=c, a=angle)

  def observe(self, state: physics.WorldState):
    """Pack the dict observation (reference: world_env.py:387-429)."""
    return self.observe_pose(state.is_circle, state.c, state.a)

  def observe_pose(self, is_circle, c, a, lcd=True):
    """Observation from bare poses (B, N) / (B, N, 2) / (B, N): obs depend
    only on (is_circle, c, a). lcd=False skips the frame render."""
    s = self.spec
    origin = physics.origin_pos(s, _Pose(is_circle=is_circle, c=c, a=a))
    rel = origin - origin[:, self._root]           # root-relative positions
    rel_a = wrap_angle(a - a[:, self._root])       # root-relative angles
    feats = torch.stack([origin[..., 0], origin[..., 1],
                         torch.cos(a), torch.sin(a),
                         rel[..., 0], rel[..., 1],
                         torch.cos(rel_a), torch.sin(rel_a)], -1)  # (B, N, 8)
    vals = feats[:, self._obs_body, self._obs_kind]
    full = utils.rmapto(vals, (self._obs_lo, self._obs_hi))
    proprio = (full[:, self._pobs_idxs] if s.pobs_size
               else torch.zeros((c.shape[0], 1), device=c.device))
    if not lcd:
      return {'full_state': full, 'proprio': proprio}
    if str(self.G.get('raster', 'exact')) == 'fast':
      # approximate pixel-center coverage (~96% agreement with PIL)
      frame = ~raster.coverage(s, is_circle, c, a, self.lcd_w,
                               self.lcd_h).any(-1)
    else:
      frame = raster.lcd_render(s, is_circle, c, a, self.lcd_w, self.lcd_h)
    return {'full_state': full, 'proprio': proprio, 'lcd': frame}

  def step(self, state: physics.WorldState, action):
    """(state, action (B, act)) -> (state', obs, reward, done, info)."""
    state = physics.step_world_batch(self.spec, state, action)
    obs = self.observe(state)
    reward = torch.zeros(action.shape[0], device=action.device)
    done = state.ep_t >= self.G.ep_len
    return state, obs, reward, done, {'timeout': done}

  def step_autoreset(self, gen: torch.Generator, state, action):
    """Step with masked auto-reset — the batched-collection primitive."""
    state, obs, reward, done, info = self.step(state, action)
    fresh = Env.reset(self, gen, done.shape[0])
    state = physics.WorldState(*(
        torch.where(done.view(-1, *([1] * (x.dim() - 1))), f, x)
        for x, f in zip(state, fresh)))
    return state, obs, reward, done, info


class WorldEnv(Env):
  """Stateful single-env shell with the reference's gym-style API.

  `reset(full_state=|proprio=)` / `step(action)` / `render` mirror the
  reference WorldEnv surface (boxLCD/world_env.py:306,431,514) on a batch of
  one world; observations come back as numpy arrays. The functional methods
  remain available via the Env base class.
  """

  def __init__(self, world_def, G=None, device=None):
    super().__init__(world_def, G, device)
    self._gen = torch.Generator(device=self.device)
    self._gen.manual_seed(0)
    self._state = None
    self.viewer = None   # made by the first render('human')

  def seed(self, seed=None):
    self._gen.manual_seed(0 if seed is None else seed)
    return [seed]

  @staticmethod
  def _to_numpy(obs):
    return {k: v[0].cpu().numpy() for k, v in obs.items()}

  def reset(self, full_state=None, proprio=None):
    if proprio is not None:
      self._state = Env.teleport(
          self, self._gen, proprio=np.asarray(proprio, np.float32)[None])
    elif full_state is not None:
      self._state = Env.teleport(
          self, self._gen, full_state=np.asarray(full_state, np.float32)[None])
    else:
      self._state = Env.reset(self, self._gen, 1)
    return self._to_numpy(Env.observe(self, self._state))

  def step(self, action):
    action = torch.as_tensor(np.asarray(action, np.float32).reshape(1, -1),
                             device=self.device)
    self._state, obs, rew, done, _ = Env.step(self, self._state, action)
    done = bool(done[0])
    return self._to_numpy(obs), float(rew[0]), done, {'timeout': done}

  @property
  def state(self):
    return self._state

  def lcd_render(self, width=None, height=None):
    width = width or self.lcd_w
    height = height or self.lcd_h
    st = self._state
    return raster.lcd_render(self.spec, st.is_circle, st.c, st.a, width,
                             height)[0].cpu().numpy()

  def render(self, mode='rgb_array', *_, return_pyglet_view=False, **__):
    """rgb_array -> the LCD frame as numpy (H, W) bool; human -> the 8x RGB
    render and the upscaled LCD side by side, with a 1-pixel separator,
    shown through the viewer (a pyglet window where one opens, else an
    ArrayViewer that records it; reference: world_env.py:514-535). Returns
    the composed (8H, 16W + 1, 3) uint8 image, or with return_pyglet_view
    what the viewer read back."""
    lcd = self.lcd_render()
    if mode != 'human':
      return lcd
    st = self._state
    hi = raster.rgb_render(self.spec, st.is_circle, st.c, st.a,
                           self.lcd_w * 8, self.lcd_h * 8)[0].cpu().numpy()
    low = (255 * lcd.astype(np.uint8))[:, :, None]
    low = low.repeat(8, 0).repeat(8, 1).repeat(3, 2)
    sep = np.zeros((hi.shape[0], 1, 3), np.uint8)
    img = np.concatenate([hi, sep, low], axis=1)
    if self.viewer is None:
      from boxlcd_tpu_torch.viewer import make_viewer
      self.viewer = make_viewer(self.lcd_w * 8, self.lcd_h * 8, self.G)
    out = self.viewer.render(img, return_rgb_array=return_pyglet_view)
    return out if return_pyglet_view else img
