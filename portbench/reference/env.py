"""The reference's env core: a world compiled from a configuration file, its
resets and its observations (a frozen copy of the arithmetic of
boxlcd_tpu_torch/envs/env.py's `Env.reset` and `Env.observe_pose`,
reference: boxLCD/world_env.py:197-304, 387-429).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import physics, raster, rutils
from portbench.reference.collision import rot_apply
from portbench.reference.spec import (
    RANDOM, ROLE_OBJECT, ROLE_ROOT, compile_world)
from portbench.reference.world_defs import Object, Robot, WorldDef


def wrap_angle(a):
  return torch.atan2(torch.sin(a), torch.cos(a))


class _Pose(NamedTuple):
  is_circle: torch.Tensor
  c: torch.Tensor
  a: torch.Tensor


def world_def(cfg):
  """The WorldDef of a configuration file's `world`: robots by registry
  type and objects by their keyword settings."""
  w = cfg['world']
  return WorldDef(robots=[Robot(**r) for r in w.get('robots', [])],
                  objects=[Object(**o) for o in w.get('objects', [])])


class World:
  """One configuration's world on one device: `reset_from_uniforms` places
  episode starts from the uniforms the program's reset draws, and
  `observe_pose` packs the observation of bare poses."""

  def __init__(self, cfg, device='cpu'):
    self.device = torch.device(device)
    self.G = rutils.AttrDict(cfg['env_config'])
    self.spec = compile_world(world_def(cfg), self.G)
    self.lcd_h = int(self.G.lcd_base)
    self.lcd_w = int(self.G.lcd_base * self.G.wh_ratio)
    self.ep_len = int(self.G.ep_len)
    s = self.spec
    self.act_size = max(1, len(s.act_keys))
    self._child_joint = {int(s.j_child[j]): j for j in range(s.jn)}
    t = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt),
                                           device=self.device)
    self._obs_lo = t(s.obs_bounds[:, 0], np.float32)
    self._obs_hi = t(s.obs_bounds[:, 1], np.float32)
    self._obs_body = t(s.obs_body, np.int64)
    self._obs_kind = t(s.obs_kind, np.int64)
    self._pobs_idxs = t(s.pobs_idxs, np.int64)
    self._root = t(s.root_of, np.int64)

  def reset_from_uniforms(self, u01):
    """Episode starts from (B, n, 4) uniforms in [0, 1): per body x, y and
    the two angle samples; the RANDOM shape coin reuses the fourth."""
    s = self.spec
    dev = self.device
    batch, n = u01.shape[0], s.n
    st = physics.init_state(s, batch, dev)
    uni = lambda u, lo, hi: torch.clamp(u * (hi - lo) + lo, min=lo)
    origin = torch.zeros((batch, n, 2), device=dev)
    angle = torch.zeros((batch, n), device=dev)
    is_circle = st.is_circle.clone()
    for i in range(n):  # creation order puts parents first
      role = int(s.role[i])
      if role in (ROLE_ROOT, ROLE_OBJECT):
        rx = float(s.rs_rangex[i])
        x = rutils.mapto(uni(u01[:, i, 0], -rx, rx), (0.0, s.width))
        lo, hi = float(s.rs_rangey_lo[i]), float(s.rs_rangey_hi[i])
        uy = (uni(u01[:, i, 1], lo, hi) if hi > lo
              else torch.full((batch,), lo, device=dev))
        y = rutils.mapto(uy, (0.0, s.height))
        if s.rs_rand_angle[i]:
          angle[:, i] = torch.atan2(uni(u01[:, i, 2], -1.0, 1.0),
                                    uni(u01[:, i, 3], -1.0, 1.0))
        origin[:, i, 0] = x
        origin[:, i, 1] = y
        if role == ROLE_OBJECT and int(s.shape_static[i]) == RANDOM:
          is_circle[:, i] = u01[:, i, 3] < 0.5
      else:  # a child: placed from its parent through the joint anchors
        j = self._child_joint[i]
        root = int(s.root_of[i])
        parent = int(s.parent_of[i])
        mangle = wrap_angle(angle[:, root] + float(s.j_angle0[j]))
        pangle = angle[:, parent]
        anc_a = torch.as_tensor(s.j_anchor_a[j], device=dev)
        anc_b = torch.as_tensor(s.j_anchor_b[j], device=dev)
        aa = rot_apply(torch.cos(pangle)[:, None], torch.sin(pangle)[:, None],
                       anc_a[None])[:, 0]
        ab = rot_apply(torch.cos(mangle)[:, None], torch.sin(mangle)[:, None],
                       anc_b[None])[:, 0]
        origin[:, i] = origin[:, parent] + aa - ab
        angle[:, i] = mangle
    c = physics.com_from_origin(s, is_circle, origin, angle)
    K = physics.consts(s, dev)
    j_ref = (angle[:, K.j_ch] - angle[:, K.j_pa]) * K.j_validf
    return st._replace(c=c, a=angle, is_circle=is_circle, j_ref=j_ref)

  def observe_pose(self, is_circle, c, a):
    """{'full_state', 'proprio', 'lcd'} of bare poses (B, N) / (B, N, 2) /
    (B, N); lcd (B, H, W) bool, background True."""
    s = self.spec
    origin = physics.origin_pos(s, _Pose(is_circle=is_circle, c=c, a=a))
    rel = origin - origin[:, self._root]
    rel_a = wrap_angle(a - a[:, self._root])
    feats = torch.stack([origin[..., 0], origin[..., 1],
                         torch.cos(a), torch.sin(a),
                         rel[..., 0], rel[..., 1],
                         torch.cos(rel_a), torch.sin(rel_a)], -1)
    vals = feats[:, self._obs_body, self._obs_kind]
    full = rutils.rmapto(vals, (self._obs_lo, self._obs_hi))
    proprio = (full[:, self._pobs_idxs] if s.pobs_size
               else torch.zeros((c.shape[0], 1), device=c.device))
    frame = raster.lcd_render(s, is_circle, c, a, self.lcd_w, self.lcd_h)
    return {'full_state': full, 'proprio': proprio, 'lcd': frame}
