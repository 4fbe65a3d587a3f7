"""Narrowphase contact-manifold generation (torch, batched over worlds).

Produces Box2D-equivalent manifolds for the shape pairs the worlds contain:
circle-circle, polygon-circle, polygon-polygon (SAT + incident-edge clipping),
and body-vs-wall half-planes. Each manifold stores both world-space data for
the velocity solver and body-local data so the NGS position solver can
recompute separations as poses change (the same split Box2D uses between
b2ContactSolver and b2PositionSolverManifold).

Every routine is elementwise over arbitrary leading dimensions: the physics
calls `collide_pair` once for all (world, pair) slots and `collide_wall` once
for all (world, body, wall) slots. Bodies whose shape is chosen per episode
('random' objects, reference: boxLCD/world_env.py:273-274) carry an
`is_circle` flag in dynamic state; the circle and polygon variants are both
computed and selected, so all shapes stay static.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.geom import MAX_VERTS

# Box2D tuning constants (b2Settings.h)
POLY_RADIUS = 0.01          # polygon/edge "skin" radius (2 * linearSlop)
LINEAR_SLOP = 0.005
BIG = 1e9


class Geom(NamedTuple):
  """World-space geometry of all bodies, recomputed each substep."""
  c: torch.Tensor          # (B, N, 2) center of mass
  cos: torch.Tensor        # (B, N) rotation cos
  sin: torch.Tensor        # (B, N) rotation sin
  is_circle: torch.Tensor  # (B, N) bool
  radius: torch.Tensor     # (N,)
  wverts: torch.Tensor     # (B, N, V, 2) world polygon vertices (about com)
  wnormals: torch.Tensor   # (B, N, V, 2)
  vmask: torch.Tensor      # (N, V) vertex-valid mask


def dot(a, b):
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def norm(d):
  return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def rot_apply(cos, sin, x):
  """R(angle) @ x for (..., 2) vectors, R = [[cos, -sin], [sin, cos]]."""
  return torch.stack([cos * x[..., 0] - sin * x[..., 1],
                      sin * x[..., 0] + cos * x[..., 1]], -1)


def rot_apply_t(cos, sin, x):
  """R(angle)^T @ x."""
  return torch.stack([cos * x[..., 0] + sin * x[..., 1],
                      -sin * x[..., 0] + cos * x[..., 1]], -1)


def _take(x, idx):
  """x[..., idx, :] per leading index: x (L, V, 2), idx (L,) -> (L, 2)."""
  return torch.take_along_dim(x, idx[..., None, None], dim=-2).squeeze(-2)


def _take1(x, idx):
  """x (L, V), idx (L,) -> (L,)."""
  return torch.take_along_dim(x, idx[..., None], dim=-1).squeeze(-1)


def _sel(cond, a, b):
  """torch.where with cond broadcast over the trailing dims of a/b."""
  while cond.dim() < a.dim():
    cond = cond[..., None]
  return torch.where(cond, a, b)


def make_geom(K, is_circle, c, cos, sin) -> Geom:
  """K: the spec's device constants (physics.consts)."""
  wverts = c[:, :, None, :] + rot_apply(cos[..., None], sin[..., None],
                                        K.verts_com)
  wnormals = rot_apply(cos[..., None], sin[..., None], K.normals)
  return Geom(c=c, cos=cos, sin=sin, is_circle=is_circle, radius=K.radius,
              wverts=wverts, wnormals=wnormals, vmask=K.vmask)


class Manifold(NamedTuple):
  """Up to 2 contact points between one body pair (world + local form)."""
  normal: torch.Tensor   # (L, 2) world, points from A to B
  points: torch.Tensor   # (L, 2, 2) world contact points
  sep: torch.Tensor      # (L, 2) separations (negative = penetrating)
  touch: torch.Tensor    # (L, 2) bool
  ids: torch.Tensor      # (L, 2) int32 feature ids for warm-start matching
  mtype: torch.Tensor    # (L,) int32: 0=circles, 1=faceA, 2=faceB
  ln: torch.Tensor       # (L, 2) local normal (in face-owner com frame)
  lpp: torch.Tensor      # (L, 2) local plane point (face-owner frame)
  lps: torch.Tensor      # (L, 2, 2) local clip points (other body's com frame)
  rad_sub: torch.Tensor  # (L,) radius term subtracted when recomputing separation


def _full(like, shape, value, dtype=None):
  return torch.full((*like.shape[:-1], *shape), value,
                    dtype=dtype or like.dtype, device=like.device)


# -- circle-circle -------------------------------------------------------------

def _collide_circles(cA, rA, cB, rB):
  d = cB - cA
  dist = norm(d)
  up = torch.zeros_like(d)
  up[..., 1] = 1.0
  n = _sel(dist > 1e-9, d / torch.clamp(dist, min=1e-9)[..., None], up)
  sep = dist - rA - rB
  touching = sep <= 0.0
  point = 0.5 * ((cA + rA[..., None] * n) + (cB - rB[..., None] * n))
  z2 = torch.zeros_like(d)
  return Manifold(
      normal=n, points=torch.stack([point, point], -2),
      sep=torch.stack([sep, torch.full_like(sep, BIG)], -1),
      touch=torch.stack([touching, torch.zeros_like(touching)], -1),
      ids=_full(d, (2,), 0, torch.int32), mtype=_full(d, (), 0, torch.int32),
      ln=z2, lpp=z2, lps=torch.zeros_like(torch.stack([d, d], -2)),
      rad_sub=rA + rB)


# -- polygon (A) vs circle (B) --------------------------------------------------

def _collide_poly_circle(wvA, wnA, vmA, cA, cosA, sinA, cB, rB):
  """Face-A manifold with a single point (b2CollidePolygonAndCircle)."""
  # separation of circle center from each face
  seps = dot(wnA, cB[..., None, :] - wvA)
  seps = torch.where(vmA, seps, torch.full_like(seps, -BIG))
  best = torch.argmax(seps, dim=-1)
  max_sep = _take1(seps, best)
  nv = vmA.sum(-1)
  nxt = torch.where(best + 1 < nv, best + 1, torch.zeros_like(best))
  v1 = _take(wvA, best)
  v2 = _take(wvA, nxt)
  # vertex-region handling
  u1 = dot(cB - v1, v2 - v1)
  u2 = dot(cB - v2, v1 - v2)
  face_n = _take(wnA, best)

  def _norm(d):
    l = norm(d)
    return _sel(l > 1e-9, d / torch.clamp(l, min=1e-9)[..., None], face_n), l

  n_v1, d1 = _norm(cB - v1)
  n_v2, d2 = _norm(cB - v2)
  inside = max_sep < 1e-9
  use_v1 = (~inside) & (u1 <= 0.0)
  use_v2 = (~inside) & (u2 <= 0.0) & (~use_v1)
  n = _sel(use_v1, n_v1, _sel(use_v2, n_v2, face_n))
  plane_pt = _sel(use_v1, v1, _sel(use_v2, v2, 0.5 * (v1 + v2)))
  sep_raw = torch.where(use_v1, d1, torch.where(use_v2, d2,
                                                dot(cB - plane_pt, face_n)))
  sep = sep_raw - rB - POLY_RADIUS
  touching = sep <= 0.0
  # world contact point: midpoint of surface points
  cAp = cB - sep_raw[..., None] * n
  cBp = cB - rB[..., None] * n
  point = 0.5 * (cAp + cBp)
  return Manifold(
      normal=n, points=torch.stack([point, point], -2),
      sep=torch.stack([sep, torch.full_like(sep, BIG)], -1),
      touch=torch.stack([touching, torch.zeros_like(touching)], -1),
      ids=_full(n, (2,), 0, torch.int32), mtype=_full(n, (), 1, torch.int32),
      ln=rot_apply_t(cosA, sinA, n),
      lpp=rot_apply_t(cosA, sinA, plane_pt - cA),
      lps=torch.zeros_like(torch.stack([n, n], -2)),  # circle center is B's com
      rad_sub=rB + POLY_RADIUS)


# -- polygon vs polygon ----------------------------------------------------------

def _max_separation(wvA, wnA, vmA, wvB, vmB):
  """Max over A's faces of min over B's verts of face-plane separation."""
  d = (dot(wnA[..., :, None, :], wvB[..., None, :, :])
       - dot(wnA, wvA)[..., :, None])                              # (L, K, V)
  d = torch.where(vmB[..., None, :], d, torch.full_like(d, BIG))
  face_sep = d.min(dim=-1).values
  face_sep = torch.where(vmA, face_sep, torch.full_like(face_sep, -BIG))
  best = torch.argmax(face_sep, dim=-1)
  return _take1(face_sep, best), best


def _clip_segment(p1, p2, id1, id2, n, offset):
  """b2ClipSegmentToLine: keep the sub-segment with dot(n, p) - offset <= 0."""
  d1 = dot(n, p1) - offset
  d2 = dot(n, p2) - offset
  den = d1 - d2
  t = d1 / torch.where(torch.abs(den) > 1e-12, den, torch.full_like(den, 1e-12))
  pm = p1 + t[..., None] * (p2 - p1)
  q1 = _sel(d1 <= 0, p1, pm)
  i1 = torch.where(d1 <= 0, id1, id2 + 16)
  q2 = _sel(d2 <= 0, p2, pm)
  i2 = torch.where(d2 <= 0, id2, id1 + 16)
  valid = torch.minimum(d1, d2) <= 0
  return q1, q2, i1, i2, valid


def _clip_face(wv_ref, wn_ref, vm_ref, ref_face, c_ref, cos_ref, sin_ref,
               wv_inc, wn_inc, vm_inc, c_inc, cos_inc, sin_inc, flip: bool):
  """Clip the incident face of `inc` against reference face `ref_face`."""
  nv_ref = vm_ref.sum(-1)
  nv_inc = vm_inc.sum(-1)
  i2 = (ref_face + 1) % MAX_VERTS
  i2 = torch.where(i2 < nv_ref, i2, torch.zeros_like(i2))
  v1 = _take(wv_ref, ref_face)
  v2 = _take(wv_ref, i2)
  ref_n = _take(wn_ref, ref_face)
  # incident face: most anti-parallel
  dots = dot(wn_inc, ref_n[..., None, :])
  dots = torch.where(vm_inc, dots, torch.full_like(dots, BIG))
  inc_face = torch.argmin(dots, dim=-1)
  j2 = (inc_face + 1) % MAX_VERTS
  j2 = torch.where(j2 < nv_inc, j2, torch.zeros_like(j2))
  p1, p2 = _take(wv_inc, inc_face), _take(wv_inc, j2)
  id1, id2 = inc_face.to(torch.int32), j2.to(torch.int32)
  tangent = v2 - v1
  tangent = tangent / torch.clamp(norm(tangent), min=1e-9)[..., None]
  # clip to both side planes of the reference edge
  q1, q2, id1, id2, ok1 = _clip_segment(p1, p2, id1, id2, -tangent,
                                        -dot(tangent, v1))
  q1, q2, id1, id2, ok2 = _clip_segment(q1, q2, id1, id2, tangent,
                                        dot(tangent, v2))
  ok = ok1 & ok2
  total_r = 2 * POLY_RADIUS
  sep1 = dot(ref_n, q1 - v1) - total_r
  sep2 = dot(ref_n, q2 - v1) - total_r
  touch = torch.stack([ok & (sep1 <= 0), ok & (sep2 <= 0)], -1)
  pts = torch.stack([q1 - (0.5 * (sep1 + total_r))[..., None] * ref_n,
                     q2 - (0.5 * (sep2 + total_r))[..., None] * ref_n], -2)
  return Manifold(
      normal=-ref_n if flip else ref_n,
      points=pts, sep=torch.stack([sep1, sep2], -1), touch=touch,
      ids=torch.stack([id1, id2], -1) + (64 if flip else 0),
      mtype=torch.full_like(id1, 2 if flip else 1),
      ln=rot_apply_t(cos_ref, sin_ref, ref_n),
      lpp=rot_apply_t(cos_ref, sin_ref, 0.5 * (v1 + v2) - c_ref),
      lps=torch.stack([rot_apply_t(cos_inc, sin_inc, q1 - c_inc),
                       rot_apply_t(cos_inc, sin_inc, q2 - c_inc)], -2),
      rad_sub=torch.full_like(sep1, total_r))


def _collide_polys(wvA, wnA, vmA, cA, cosA, sinA, wvB, wnB, vmB, cB, cosB,
                   sinB):
  sepA, faceA = _max_separation(wvA, wnA, vmA, wvB, vmB)
  sepB, faceB = _max_separation(wvB, wnB, vmB, wvA, vmA)
  total_r = 2 * POLY_RADIUS
  no_contact = (sepA > total_r) | (sepB > total_r)
  use_b = sepB > sepA + 0.1 * LINEAR_SLOP
  mA = _clip_face(wvA, wnA, vmA, faceA, cA, cosA, sinA,
                  wvB, wnB, vmB, cB, cosB, sinB, flip=False)
  mB = _clip_face(wvB, wnB, vmB, faceB, cB, cosB, sinB,
                  wvA, wnA, vmA, cA, cosA, sinA, flip=True)
  m = Manifold(*(_sel(use_b, b, a) for a, b in zip(mA, mB)))
  return m._replace(touch=m.touch & ~no_contact[..., None])


# -- unified pair dispatch --------------------------------------------------------

def collide_pair(geom: Geom, a, b) -> Manifold:
  """Manifolds for body pairs (a[p], b[p]) of every world: fields (B, P, ...).

  a, b: (P,) long index tensors on the geometry's device. Dispatches on the
  dynamic is_circle flags."""
  cA, cB = geom.c[:, a], geom.c[:, b]
  rA = geom.radius[a].expand(cA.shape[:-1])
  rB = geom.radius[b].expand(cB.shape[:-1])
  cosA, sinA = geom.cos[:, a], geom.sin[:, a]
  cosB, sinB = geom.cos[:, b], geom.sin[:, b]
  wvA, wnA = geom.wverts[:, a], geom.wnormals[:, a]
  wvB, wnB = geom.wverts[:, b], geom.wnormals[:, b]
  vmA = geom.vmask[a].expand(wvA.shape[:-1])
  vmB = geom.vmask[b].expand(wvB.shape[:-1])

  m_cc = _collide_circles(cA, rA, cB, rB)
  m_pc = _collide_poly_circle(wvA, wnA, vmA, cA, cosA, sinA, cB, rB)  # A poly
  m_cp_raw = _collide_poly_circle(wvB, wnB, vmB, cB, cosB, sinB, cA, rA)
  # flip cp so normal points A->B and face owner is marked as B (faceB)
  m_cp = m_cp_raw._replace(normal=-m_cp_raw.normal,
                           mtype=torch.full_like(m_cp_raw.mtype, 2))
  m_pp = _collide_polys(wvA, wnA, vmA, cA, cosA, sinA,
                        wvB, wnB, vmB, cB, cosB, sinB)

  ia, ib = geom.is_circle[:, a], geom.is_circle[:, b]

  def sel(f_cc, f_pc, f_cp, f_pp):
    fb = _sel(ib, f_cc, f_cp)      # A circle: B circle -> cc else cp
    fa = _sel(ib, f_pc, f_pp)      # A poly:   B circle -> pc else pp
    return _sel(ia, fb, fa)

  return Manifold(*(sel(*fs) for fs in zip(m_cc, m_pc, m_cp, m_pp)))


# -- wall (half-plane) contacts -----------------------------------------------------

class WallManifold(NamedTuple):
  points: torch.Tensor   # (B, N, W, 2, 2) world
  sep: torch.Tensor      # (B, N, W, 2)
  touch: torch.Tensor    # (B, N, W, 2) bool
  ids: torch.Tensor      # (B, N, W, 2) int32
  lps: torch.Tensor      # (B, N, W, 2, 2) local anchor in body com frame
  rad_sub: torch.Tensor  # (B, N, W)


def collide_wall(geom: Geom, wn, woff) -> WallManifold:
  """Contacts of every body against every inward half-plane
  sep(p) = wn.p - woff; wn (W, 2), woff (W,).

  Walls are Box2D edge chains in the reference (boxLCD/world_env.py:309-316);
  since they bound the arena, half-planes are equivalent for interior bodies.
  """
  c = geom.c[:, :, None, :]                                    # (B, N, 1, 2)
  r = geom.radius[None, :, None]                               # (1, N, 1)
  wv = geom.wverts[:, :, None]                                 # (B, N, 1, V, 2)
  vm = geom.vmask[None, :, None]                               # (1, N, 1, V)
  cos, sin = geom.cos[..., None], geom.sin[..., None]          # (B, N, 1)

  # circle variant: single point
  sep_c = dot(wn, c) - woff - r - POLY_RADIUS                  # (B, N, W)
  pt_c = c - r[..., None] * wn
  # polygon variant: two deepest vertices
  seps = dot(wv, wn[:, None, :]) - woff[:, None] - 2 * POLY_RADIUS
  seps = torch.where(vm, seps, torch.full_like(seps, BIG))     # (B, N, W, V)
  order = torch.sort(seps, dim=-1, stable=True).indices
  i1, i2 = order[..., 0], order[..., 1]
  is_c = geom.is_circle[..., None, None]                       # (B, N, 1, 1)
  wvx = wv.expand(*seps.shape, 2)

  sep = torch.where(is_c, torch.stack([sep_c, torch.full_like(sep_c, BIG)], -1),
                    torch.stack([_take1(seps, i1), _take1(seps, i2)], -1))
  pts = torch.where(is_c[..., None],
                    torch.stack([pt_c, pt_c], -2).expand(*sep.shape, 2),
                    torch.stack([_take(wvx, i1), _take(wvx, i2)], -2))
  ids = torch.where(is_c, torch.zeros_like(sep, dtype=torch.int32),
                    torch.stack([i1, i2], -1).to(torch.int32))
  touch = sep <= 0.0
  # local anchors for the position solver: polygon vertices rotate with the
  # body; a circle's correction always acts through its center (zero anchor)
  lps_poly = rot_apply_t(cos[..., None], sin[..., None], pts - c[..., None, :])
  lps = torch.where(is_c[..., None], torch.zeros_like(lps_poly), lps_poly)
  rad_sub = torch.where(is_c[..., 0], r + POLY_RADIUS,
                        torch.full_like(sep_c, 2 * POLY_RADIUS))
  return WallManifold(points=pts, sep=sep, touch=touch, ids=ids, lps=lps,
                      rad_sub=rad_sub)
