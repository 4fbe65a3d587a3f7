"""A collection dispatch replayed by the plain reference: its resets and
random actions drawn again from the generator state the dispatch drew them
from (the same calls, shapes and order as the program's collection path:
per-world reset uniforms (B, n, 4), then the (B, T, act) action uniforms,
mapped to clamp(2u - 1, -1)), then a sample of its worlds stepped by the
plain physics and observed, on the device of the world it is given (the
card, after the window has closed, in a run; the CPU in the tests)."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import physics


def draws(world, gen_state, device, batch):
  """(reset uniforms (B, n, 4), actions (B, T, act)) on the world's
  device."""
  g = torch.Generator(device=device)
  g.set_state(gen_state)
  u01 = torch.rand((batch, world.spec.n, 4), generator=g, device=device)
  u = torch.rand((batch, world.ep_len, world.act_size), generator=g,
                 device=device)
  return (u01.to(world.device),
          torch.clamp(u * 2.0 - 1.0, min=-1.0).to(world.device))


def _bf16(state):
  """The state held in bfloat16: every float field rounded."""
  return physics.WorldState(*(
      x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x
      for x in state))


class GraphStep:
  """The plain step on the card with its substep as one CUDA graph:
  captured once, then replayed substep after substep on copies of each
  state. The same kernels in the same order as the eager step, so the same
  numbers; only the host's launch of each op is saved (a substep at
  180/60 iterations is some 10^5 small ops)."""

  def __init__(self, spec, state, actions):
    self.spec = spec
    self.K = physics.consts(spec, state.c.device)
    self.inp = physics.WorldState(*(x.clone() for x in state))
    self.speed = physics.motor_speeds(spec, actions).clone()
    self.changed = physics.motor_wake(spec, state, self.speed).clone()
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph):
      self.out = physics.plain_substep(spec, self.K, self.inp, self.speed,
                                       self.changed)

  def __call__(self, state, actions):
    speed = physics.motor_speeds(self.spec, actions)
    self.speed.copy_(speed)
    self.changed.copy_(physics.motor_wake(self.spec, state, speed))
    for _ in range(self.spec.substeps):
      for dst, src in zip(self.inp, state):
        dst.copy_(src)
      self.graph.replay()
      state = physics.WorldState(*(x.clone() for x in self.out))
    return state._replace(ep_t=state.ep_t + 1, prev_motor=speed)


def stepper(world, state, actions, graph=None):
  """(state, actions) -> next state: a GraphStep on the card (graph=None
  or True), else the eager plain step."""
  if graph is None:
    graph = world.device.type == 'cuda'
  if graph:
    return GraphStep(world.spec, state, actions)
  return lambda st, act: physics.step_world_batch(world.spec, st, act)


def replay(world, gen_state, device, batch, idx, steps, bf16=False,
           graph=None):
  """The observations o_0 .. o_{steps-1} (o_t: the pose before action t) of
  worlds `idx` of a dispatch of `batch` worlds, and all their actions, as
  numpy: {'action' (S, T, act), 'full_state' (S, steps, obs), 'proprio',
  'lcd' (S, steps, H, W) bool}. bf16=True holds the state in bfloat16
  (rounded before each observation and step): the control. On the card
  the steps replay one CUDA graph of the plain step (graph=False: eager)."""
  u01, actions = draws(world, gen_state, device, batch)
  idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                        device=world.device)
  u01, actions = u01[idx], actions[idx]
  state = world.reset_from_uniforms(u01)
  obs, step = [], None
  for t in range(steps):
    if bf16:
      state = _bf16(state)
    obs.append(world.observe_pose(state.is_circle, state.c, state.a))
    if t < steps - 1:
      step = step or stepper(world, state, actions[:, t], graph)
      state = step(state, actions[:, t])
  out = {k: torch.stack([o[k] for o in obs], 1).cpu().numpy()
         for k in ('full_state', 'proprio', 'lcd')}
  out['action'] = actions.cpu().numpy()
  return out
