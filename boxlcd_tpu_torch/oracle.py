"""CPU Box2D oracle: the reference's world construction and stepping on the
real pybox2d, to produce golden trajectories for the port's physics (the
port of tests/oracle.py; reference: boxLCD/world_env.py:197-304 body
creation, :431-458 stepping).

pybox2d is optional: HAVE_BOX2D says whether it imports, and Box2DOracle
raises without it. The package itself never steps Box2D; the parity check
(boxlcd_tpu_torch/parity.py) and its table script do. pybox2d is a host
package: the card's host does not carry it.
"""
from __future__ import annotations

import numpy as np

try:
  import Box2D
  from Box2D.b2 import (circleShape, edgeShape, fixtureDef, polygonShape,
                        revoluteJointDef)
  HAVE_BOX2D = True
except ImportError:  # pragma: no cover
  HAVE_BOX2D = False

from boxlcd_tpu_torch.world_defs import ROBOT_FILLER


def _mk_shape(sh):
  if sh.kind == 'circle':
    return circleShape(radius=sh.radius, pos=(0, 0))
  return polygonShape(vertices=[tuple(v) for v in sh.verts])


class Box2DOracle:
  """Minimal mirror of the reference WorldEnv on pybox2d."""

  def __init__(self, env):
    """env: a boxlcd_tpu_torch Env (its world_def, config and spec)."""
    if not HAVE_BOX2D:
      raise RuntimeError('Box2DOracle needs pybox2d (import Box2D failed)')
    self.env = env
    self.G = env.G
    self.spec = env.spec
    self.world_def = env.world_def
    self.robots = [ROBOT_FILLER[r.type](r, self.G)
                   for r in env.world_def.robots]

  @property
  def width(self):
    return self.spec.width

  @property
  def height(self):
    return self.spec.height

  def reset_from(self, origin, angle, is_circle):
    """Build the Box2D world at the given poses (origin frame) and shapes."""
    W, H = float(self.width), float(self.height)
    self.world = Box2D.b2World(gravity=tuple(self.world_def.gravity))
    if self.G.walls:
      for verts in ([(0, 0), (W, 0)], [(0, 0), (0, H)], [(W, 0), (W, H)],
                    [(0, H), (W, H)]):
        self.world.CreateStaticBody(shapes=edgeShape(vertices=verts))
    else:
      self.world.CreateStaticBody(shapes=edgeShape(
          vertices=[(-1000.0 * W, 0), (1000.0 * W, 0)]))

    self.bodies = []
    self.joints = []
    bi = 0
    for robot in self.robots:
      rb = robot.root_body
      fixture = fixtureDef(shape=_mk_shape(rb.shape),
                           density=rb.density if rb.density is not None
                           else 1.0,
                           categoryBits=rb.categoryBits, maskBits=rb.maskBits,
                           friction=1.0)
      root = self.world.CreateDynamicBody(
          position=(float(origin[bi][0]), float(origin[bi][1])),
          angle=float(angle[bi]), fixtures=fixture,
          angularDamping=robot.angularDamping,
          linearDamping=robot.linearDamping)
      self.bodies.append(root)
      idx_of = {'root': root}
      bi += 1
      for bj_name, joint in robot.joints.items():
        body = robot.bodies[bj_name]
        fixture = fixtureDef(shape=_mk_shape(body.shape), density=1,
                             restitution=0.0, categoryBits=body.categoryBits,
                             maskBits=body.maskBits, friction=body.friction)
        dyn = self.world.CreateDynamicBody(
            position=(float(origin[bi][0]), float(origin[bi][1])),
            angle=float(angle[bi]), fixtures=fixture)
        self.bodies.append(dyn)
        rjd = revoluteJointDef(
            bodyA=idx_of[joint.parent], bodyB=dyn,
            localAnchorA=tuple(joint.anchorA),
            localAnchorB=tuple(joint.anchorB),
            enableMotor=True, enableLimit=joint.limited,
            maxMotorTorque=float(joint.torque), motorSpeed=0,
            lowerAngle=float(joint.limits[0]),
            upperAngle=float(joint.limits[1]))
        self.joints.append(self.world.CreateJoint(rjd))
        idx_of[bj_name] = dyn
        bi += 1
    for obj in self.world_def.objects:
      circ = bool(is_circle[bi])
      shape = (circleShape(radius=obj.size, pos=(0, 0)) if circ
               else polygonShape(box=(obj.size, obj.size)))
      fixture = fixtureDef(shape=shape, density=obj.density,
                           friction=obj.friction,
                           categoryBits=obj.categoryBits,
                           restitution=obj.restitution)
      body = self.world.CreateDynamicBody(
          position=(float(origin[bi][0]), float(origin[bi][1])),
          angle=float(angle[bi]), fixtures=fixture,
          linearDamping=obj.linearDamping, angularDamping=obj.angularDamping)
      self.bodies.append(body)
      bi += 1

  def step(self, action):
    """One env step = joint control + 3 substeps (world_env.py:431-452), at
    the reference's 180/60 solver iterations."""
    s = self.spec
    action = np.clip(np.asarray(action, np.float64), -1, 1)
    # spec slots are in Box2D island solve order; self.joints is in creation
    # order: s.j_order maps slot -> creation index
    for j in range(s.jn):
      if s.j_act[j] >= 0:
        self.joints[int(s.j_order[j])].motorSpeed = float(
            s.j_speed[j] * action[s.j_act[j]])
    fps = self.G.fps
    if fps < 30:
      for _ in range(3):
        self.world.Step(1.0 / (fps * 3), 6 * 30, 2 * 30)
    else:
      self.world.Step(1.0 / fps, 6 * 30, 2 * 30)

  def poses(self):
    origin = np.array([[b.position.x, b.position.y] for b in self.bodies])
    ang = np.array([b.angle for b in self.bodies])
    return origin, ang
