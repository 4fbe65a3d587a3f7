"""Declarative world specification structs + robot morphology registry.

This is the scene-description vocabulary of the framework: a WorldDef lists
robots and passive objects; a registry of "robot fillers" expands a partial
Robot into concrete bodies/joints. Semantics (names, sizes, joint angles,
limits, collision filter bits) follow the reference testbed
(reference: boxLCD/world_defs.py) so that environments here describe the
same worlds — but shapes are plain data (no Box2D objects): the engine
compiles them into struct-of-arrays constants for the torch physics core.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

SCALE = 30.0  # world scale constant (reference: boxLCD/world_defs.py:8)


# -- shapes (plain data, engine-compilable) ----------------------------------

class ShapeSpec(NamedTuple):
  kind: str                     # 'circle' | 'polygon'
  radius: float = 0.0           # circle radius
  verts: Tuple = ()             # polygon vertices (local coords, any order)
  box: bool = False             # True when built via box= (SetAsBox vert order)


def circle(radius: float) -> ShapeSpec:
  return ShapeSpec('circle', radius=float(radius))


def poly(verts) -> ShapeSpec:
  return ShapeSpec('polygon', verts=tuple(tuple(map(float, v)) for v in verts))


def box(hw: float, hh: float) -> ShapeSpec:
  """Axis-aligned box from half-extents (matches Box2D polygonShape(box=...)).

  Keeps b2PolygonShape::SetAsBox vertex order (BL, BR, TR, TL) — the order
  `shape.vertices` reports, which the reference's rasterizer traverses.
  """
  return ShapeSpec('polygon', verts=(
      (-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)), box=True)


# -- world-def structs --------------------------------------------------------
# Field names and defaults mirror the reference structs
# (reference: boxLCD/world_defs.py:11-59).

class Object(NamedTuple):
  name: str
  shape: str = 'box'            # 'box' | 'circle' | 'random'
  size: float = 0.5
  linearDamping: float = 0.0
  angularDamping: float = 0.0
  density: float = 1.0
  friction: float = 0.5
  restitution: float = 0.0
  categoryBits: int = 0x0110
  rand_angle: int = 1
  rangex: Optional[Tuple[float, float]] = None
  rangey: Optional[Tuple[float, float]] = None


class Body(NamedTuple):
  shape: ShapeSpec
  density: float = 1.0
  maskBits: int = 0x001
  categoryBits: int = 0x0020
  friction: float = 1.0


class Joint(NamedTuple):
  parent: str
  angle: float
  anchorA: tuple
  anchorB: tuple
  limits: Tuple[float, float]
  limited: bool = True
  speed: float = 8.0
  torque: float = 150.0


class Robot(NamedTuple):
  type: str
  name: str
  root_body: Optional[Body] = None
  bodies: Optional[Dict[str, Body]] = None
  joints: Optional[Dict[str, Joint]] = None
  rand_angle: int = 0
  angularDamping: float = 0.0
  linearDamping: float = 0.0
  bound: float = 1.5  # spatial extent; keeps spawn away from walls


class WorldDef(NamedTuple):
  robots: List[Robot] = []
  objects: List[Object] = []
  gravity: Tuple[float, float] = (0.0, -9.81)
  forcetorque: int = 0


# -- robot morphology registry -------------------------------------------------

ROBOT_FILLER = {}


def register(name):
  def _reg(func):
    ROBOT_FILLER[name] = func
    return func
  return _reg


@register('urchin')
def make_urchin(robot, G):
  """3-legged radial hopper (reference: boxLCD/world_defs.py:78-95)."""
  leg_w, leg_h = 8 / SCALE, 40 / SCALE
  leg = box(leg_w / 2, leg_h / 2)
  bodies = {n: Body(leg, maskBits=0x011, density=1.0) for n in ('aleg', 'bleg', 'cleg')}
  joints = {
      'aleg': Joint('root', 0.0, (0, 0), (0, leg_h / 2), (-1.0, 1.0), limited=True),
      'bleg': Joint('root', 2.0, (0, 0), (0, leg_h / 2), (-1.0, 1.0), limited=True),
      'cleg': Joint('root', 4.2, (0, 0), (0, leg_h / 2), (-1.0, 1.0), limited=True),
  }
  return Robot(type=robot.type, name=robot.name, root_body=Body(circle(0.8 * leg_w)),
               bodies=bodies, joints=joints, rand_angle=1, bound=1.25)


@register('luxo')
def make_luxo(robot, G):
  """Hopping lamp (reference: boxLCD/world_defs.py:97-124)."""
  vert, side = 10 / SCALE, 5 / SCALE
  leg_w, leg_h = 8 / SCALE, 24 / SCALE
  ll_h = 20 / SCALE
  head = [(x * 0.8 / SCALE, y * 0.8 / SCALE)
          for x, y in [(-15, 15), (20, 25), (20, -25), (-15, -15)]]
  return Robot(
      type=robot.type, name=robot.name,
      root_body=Body(poly(head), density=0.1, maskBits=0x011),
      bodies={
          'lhip': Body(box(leg_w / 2, leg_h / 2), maskBits=0x011),
          'lknee': Body(box(0.8 * leg_w / 2, ll_h / 2), maskBits=0x011),
          'lfoot': Body(box(leg_h, leg_w / 2), maskBits=0x011),
      },
      joints={
          'lhip': Joint('root', -0.5, (-side, -vert), (0, leg_h / 2), (-0.1, 0.1)),
          'lknee': Joint('lhip', 0.5, (0, -leg_h / 2), (0, ll_h / 2), (-0.9, 0.9)),
          'lfoot': Joint('lknee', 0.0, (0, -leg_h / 2), (0, leg_w / 2), (-0.5, 0.9)),
      },
      bound=2.0)


@register('quad')
def make_quad(robot, G):
  """Urchin variant with fixed spawn angle (reference: boxLCD/world_defs.py:129-146)."""
  r = make_urchin(robot, G)
  return r._replace(rand_angle=0, bound=1.5)


@register('legs')
def make_legs(robot, G):
  """Two-legged radial body (reference: boxLCD/world_defs.py:149-164)."""
  leg_w, leg_h = 8 / SCALE, 40 / SCALE
  leg = box(leg_w / 2, leg_h / 2)
  bodies = {n: Body(leg, maskBits=0x011, density=1.0) for n in ('aleg', 'bleg')}
  joints = {
      'aleg': Joint('root', -1.0, (0, 0), (0, leg_h / 2), (-1.0, 1.0), limited=True),
      'bleg': Joint('root', 1.0, (0, 0), (0, leg_h / 2), (-1.0, 1.0), limited=True),
  }
  return Robot(type=robot.type, name=robot.name, root_body=Body(circle(0.8 * leg_w)),
               bodies=bodies, joints=joints, rand_angle=0, bound=1.5)


@register('crab')
def make_crab(robot, G):
  """Crab with legs, arms and 2-finger claws (reference: boxLCD/world_defs.py:168-249)."""
  vert, side = 12 / SCALE, 20 / SCALE
  leg_w, leg_h = 8 / SCALE, 20 / SCALE
  ll_h = 20 / SCALE
  arm_w, arm_h = 8 / SCALE, 20 / SCALE
  claw_w, claw_h = 4 / SCALE, 16 / SCALE
  hull = [(0.9 * x / SCALE, 0.9 * y / SCALE)
          for x, y in [(-25, 0), (-20, 16), (20, 16), (25, 0), (20, -16), (-20, -16)]]
  arm = box(arm_w / 2, arm_h / 2)
  claw = box(claw_w / 2, claw_h / 2)
  base_mask, claw_mask = 0x001, 0x011
  bodies = {
      'lhip': Body(box(leg_w / 2, leg_h / 2), maskBits=base_mask),
      'lknee': Body(box(0.8 * leg_w / 2, ll_h / 2), maskBits=base_mask),
      'rhip': Body(box(leg_w / 2, leg_h / 2), maskBits=base_mask),
      'rknee': Body(box(0.8 * leg_w / 2, ll_h / 2), maskBits=base_mask),
      'lshoulder': Body(arm, maskBits=claw_mask),
      'lelbow': Body(arm, maskBits=claw_mask),
      'rshoulder': Body(arm, maskBits=claw_mask),
      'relbow': Body(arm, maskBits=claw_mask),
      'llclaw0': Body(claw, maskBits=claw_mask),
      'llclaw1': Body(claw, maskBits=claw_mask),
      'lrclaw0': Body(claw, maskBits=claw_mask),
      'lrclaw1': Body(claw, maskBits=claw_mask),
      'rlclaw0': Body(claw, maskBits=claw_mask),
      'rlclaw1': Body(claw, maskBits=claw_mask),
      'rrclaw0': Body(claw, maskBits=claw_mask),
      'rrclaw1': Body(claw, maskBits=claw_mask),
  }
  joints = {
      'lhip': Joint('root', -0.5, (-side, -vert), (0, leg_h / 2), (-1.5, 0.5)),
      'rhip': Joint('root', 0.5, (side, -vert), (0, leg_h / 2), (0.5, 1.5)),
      'lknee': Joint('lhip', 0.5, (0, -leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
      'rknee': Joint('rhip', -0.5, (0, -leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
      'lshoulder': Joint('root', 2.0, (-side, vert), (0, -arm_h / 2), (-3.0, 3.0), limited=False),
      'rshoulder': Joint('root', -2.0, (side, vert), (0, -arm_h / 2), (-3.0, 3.0), limited=False),
      'lelbow': Joint('lshoulder', 3.0, (0, arm_h / 2), (0, -arm_h / 2), (-2.0, 2.0), limited=False),
      'relbow': Joint('rshoulder', -3.0, (0, arm_h / 2), (0, -arm_h / 2), (-2.0, 2.0), limited=False),
      'llclaw0': Joint('lelbow', 2.25, (0, arm_h / 2), (0, -claw_h / 2), (-2.0, 1.0)),
      'llclaw1': Joint('llclaw0', 3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
      'lrclaw0': Joint('lelbow', -2.25, (0, arm_h / 2), (0, -claw_h / 2), (-1.0, 2.0)),
      'lrclaw1': Joint('lrclaw0', -3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
      'rlclaw0': Joint('relbow', 2.25, (0, arm_h / 2), (0, -claw_h / 2), (-2.0, 1.0)),
      'rlclaw1': Joint('rlclaw0', 3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
      'rrclaw0': Joint('relbow', -2.25, (0, arm_h / 2), (0, -claw_h / 2), (-1.0, 2.0)),
      'rrclaw1': Joint('rrclaw0', -3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
  }
  root = Body(poly(hull), density=1.0, maskBits=base_mask, categoryBits=0x0020)
  return Robot(type=robot.type, name=robot.name, root_body=root,
               bodies=bodies, joints=joints, bound=2.0)


@register('walker')
def make_walker(robot, G):
  """Bipedal walker with one arm (reference: boxLCD/world_defs.py:252-301)."""
  leg_down = -6 / SCALE
  leg_w, leg_h = 10 / SCALE, 24 / SCALE
  arm_w, arm_h = 8 / SCALE, 20 / SCALE
  claw_w, claw_h = 6 / SCALE, 16 / SCALE
  hull = [(0.8 * x / SCALE, 0.8 * y / SCALE)
          for x, y in [(-30, 9), (6, 9), (34, 1), (34, -8), (-30, -8)]]
  arm = box(arm_w / 2, arm_h / 2)
  claw = box(claw_w / 2, claw_h / 2)
  claw_mask, arm_mask = 0x011, 0x001
  bodies = {
      'lhip': Body(box(leg_w / 2, leg_h / 2)),
      'lknee': Body(box(0.8 * leg_w / 2, leg_h / 2)),
      'rhip': Body(box(leg_w / 2, leg_h / 2)),
      'rknee': Body(box(0.8 * leg_w / 2, leg_h / 2)),
      'shoulder': Body(arm, maskBits=arm_mask, density=0.1),
      'elbow': Body(arm, maskBits=arm_mask, density=0.1),
      'lclaw0': Body(claw, maskBits=claw_mask, density=0.1),
      'lclaw1': Body(claw, maskBits=claw_mask, density=0.1),
      'rclaw0': Body(claw, maskBits=claw_mask, density=0.1),
      'rclaw1': Body(claw, maskBits=claw_mask, density=0.1),
  }
  joints = {
      'lhip': Joint('root', 0.05, (0.0, leg_down), (0, leg_h / 2), (-0.8, 1.1)),
      'lknee': Joint('lhip', 0.05, (0, -leg_h / 2), (0, leg_h / 2), (-1.6, -0.1)),
      'rhip': Joint('root', -0.05, (0.0, leg_down), (0, leg_h / 2), (-0.8, 1.1)),
      'rknee': Joint('rhip', -0.05, (0, -leg_h / 2), (0, leg_h / 2), (-1.6, -0.1)),
      'shoulder': Joint('root', 2.0, (0, 5 / SCALE), (0, -arm_h / 2), (-3.0, 3.0), limited=False),
      'elbow': Joint('shoulder', 3.0, (0, arm_h / 2), (0, -arm_h / 2), (-2.0, 2.0), limited=False),
      'lclaw0': Joint('elbow', 2.25, (0, arm_h / 2), (0, -claw_h / 2), (-2.0, 1.0)),
      'lclaw1': Joint('lclaw0', 3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
      'rclaw0': Joint('elbow', -2.25, (0, arm_h / 2), (0, -claw_h / 2), (-1.0, 2.0)),
      'rclaw1': Joint('rclaw0', -3.75, (0, claw_h / 2), (0, -claw_h / 2), (0.0, 0.0)),
  }
  return Robot(type=robot.type, name=robot.name, root_body=Body(poly(hull)),
               bodies=bodies, joints=joints)


@register('gingy')
def make_gingy(robot, G):
  """Gingerbread-man morphology (reference: boxLCD/world_defs.py:304-337)."""
  vert, side = 10 / SCALE, 2 / SCALE
  body_w, body_h = 8 / SCALE, 25 / SCALE
  arm_w, arm_h = 8 / SCALE, 25 / SCALE
  leg_w, leg_h = 8 / SCALE, 30 / SCALE
  arm = box(arm_w / 2, arm_h / 2)
  leg = box(leg_w / 2, leg_h / 2)
  bodies = {
      'body': Body(box(body_w / 2, body_h / 2), density=1.0),
      'larm': Body(arm, maskBits=0x011),
      'rarm': Body(arm, maskBits=0x011),
      'llarm': Body(arm, maskBits=0x011),
      'rlarm': Body(arm, maskBits=0x011),
      'lleg': Body(leg, density=1.0),
      'rleg': Body(leg, density=1.0),
  }
  joints = {
      'body': Joint('root', 0.0, (0, -vert), (0, body_h / 2), (-0.1, 0.1)),
      'larm': Joint('body', 1.5, (-side, vert), (0, arm_h / 2), (-1.5, 0.8)),
      'rarm': Joint('body', -1.5, (side, vert), (0, arm_h / 2), (-1.5, 0.8)),
      'llarm': Joint('larm', 1.5, (0, -arm_h / 2), (0, arm_h / 2), (-1.5, 1.5)),
      'rlarm': Joint('rarm', -1.5, (0, -arm_h / 2), (0, arm_h / 2), (-1.5, 1.5)),
      'lleg': Joint('body', 0.8, (-side, -vert), (0, leg_h / 2), (-0.2, 0.4)),
      'rleg': Joint('body', -0.8, (side, -vert), (0, leg_h / 2), (-0.4, 0.2)),
  }
  return Robot(type=robot.type, name=robot.name,
               root_body=Body(circle(10 / SCALE), density=0.01),
               bodies=bodies, joints=joints)


@register('octo')
def make_octo(robot, G):
  """4 two-segment legs around a disc (reference: boxLCD/world_defs.py:339-367)."""
  leg_w, leg_h = 8 / SCALE, 25 / SCALE
  leg = box(leg_w / 2, leg_h / 2)
  bodies = {f'{c}leg{i}': Body(leg, maskBits=0x011, density=1.0)
            for c in 'abcd' for i in (1, 2)}
  joints = {}
  for k, c in enumerate('abcd'):
    joints[f'{c}leg1'] = Joint('root', float(k), (0, 0), (0, leg_h / 2),
                               (-1.0, 1.0), limited=False)
    joints[f'{c}leg2'] = Joint(f'{c}leg1', float(k), (0, -leg_h / 2), (0, leg_h / 2),
                               (-1.0, 1.0), limited=False)
  return Robot(type=robot.type, name=robot.name,
               root_body=Body(circle(1.5 * leg_w), density=0.1),
               bodies=bodies, joints=joints, rand_angle=1)


@register('spider')
def make_spider(robot, G):
  """4 legs (2 down, 2 up) around a disc (reference: boxLCD/world_defs.py:370-445)."""
  vert, side = 8 / SCALE, 8 / SCALE
  leg_w, leg_h = 6 / SCALE, 20 / SCALE
  ll_h = 20 / SCALE
  arm_w, arm_h = 6 / SCALE, 26 / SCALE
  arm = box(arm_w / 2, arm_h / 2)
  base_mask, claw_mask = 0x001, 0x011
  bodies = {
      'lhip': Body(box(leg_w / 2, leg_h / 2), maskBits=base_mask),
      'lknee': Body(box(0.8 * leg_w / 2, ll_h / 2), maskBits=base_mask),
      'rhip': Body(box(leg_w / 2, leg_h / 2), maskBits=base_mask),
      'rknee': Body(box(0.8 * leg_w / 2, ll_h / 2), maskBits=base_mask),
      'ulhip': Body(arm, maskBits=claw_mask, density=0.1),
      'ulknee': Body(arm, maskBits=claw_mask, density=0.1),
      'urhip': Body(arm, maskBits=claw_mask, density=0.1),
      'urknee': Body(arm, maskBits=claw_mask, density=0.1),
      'shoulder': Body(arm, maskBits=claw_mask, density=0.5),
      'elbow': Body(arm, maskBits=claw_mask, density=0.1),
      'lclaw0': Body(box(4 / SCALE / 2, 22 / SCALE / 2), maskBits=claw_mask, density=0.1),
      'rclaw0': Body(box(4 / SCALE / 2, 22 / SCALE / 2), maskBits=claw_mask, density=0.1),
  }
  joints = {
      'lhip': Joint('root', -1.0, (-side, -vert), (0, leg_h / 2), (-1.5, 0.5)),
      'rhip': Joint('root', 1.0, (side, -vert), (0, leg_h / 2), (0.5, 1.5)),
      'lknee': Joint('lhip', 0.5, (0, -leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
      'rknee': Joint('rhip', -0.5, (0, -leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
      'ulhip': Joint('root', 1.5, (-side, vert), (0, -leg_h / 2), (-1.5, 0.5)),
      'urhip': Joint('root', -1.5, (side, vert), (0, -leg_h / 2), (0.5, 1.5)),
      'ulknee': Joint('ulhip', -0.5, (0, leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
      'urknee': Joint('urhip', 0.5, (0, leg_h / 2), (0, ll_h / 2), (-0.5, 0.5)),
  }
  root = Body(circle(10 / SCALE), density=1.0, maskBits=claw_mask, categoryBits=0x0020)
  return Robot(type=robot.type, name=robot.name, root_body=root,
               bodies=bodies, joints=joints, bound=1.3)
