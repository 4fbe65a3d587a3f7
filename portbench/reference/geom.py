"""Static geometry helpers used by the spec compiler (host-side numpy).

Convex hull construction, CCW ordering, and mass-property computation follow
Box2D's b2PolygonShape::Set / ComputeMass semantics so that compiled worlds
have the same inertial behavior as the reference's Box2D bodies.
"""
from __future__ import annotations

import numpy as np

MAX_VERTS = 8


def convex_hull_ccw(verts: np.ndarray) -> np.ndarray:
  """Convex hull in counter-clockwise order (Andrew's monotone chain)."""
  pts = np.unique(np.asarray(verts, dtype=np.float64), axis=0)
  if len(pts) < 3:
    raise ValueError('polygon needs >= 3 distinct vertices')
  order = np.lexsort((pts[:, 1], pts[:, 0]))
  pts = pts[order]

  def half(points):
    out = []
    for p in points:
      while len(out) >= 2 and np.cross(out[-1] - out[-2], p - out[-2]) <= 0:
        out.pop()
      out.append(p)
    return out

  lower = half(pts)
  upper = half(pts[::-1])
  hull = np.array(lower[:-1] + upper[:-1])
  return hull  # CCW by construction


def b2_set_order(verts: np.ndarray) -> np.ndarray:
  """Convex hull in Box2D's b2PolygonShape::Set order.

  Box2D gift-wraps CCW starting from the rightmost-lowest point (after
  welding near-duplicate points), and the resulting `shape.vertices` order is
  what the reference rasterizes (reference: boxLCD/world_env.py:501-502).
  Matching it matters because PIL's polygon corner handling depends on the
  edge traversal order.
  """
  pts = np.asarray(verts, dtype=np.float64)
  weld2 = (0.5 * 0.005) ** 2  # (0.5 * b2_linearSlop)^2
  uniq = []
  for p in pts:
    if all(((p - u) ** 2).sum() > weld2 for u in uniq):
      uniq.append(p)
  pts = np.array(uniq)
  n = len(pts)
  assert n >= 3, 'polygon needs >= 3 distinct vertices'
  i0 = 0
  for i in range(1, n):
    if (pts[i, 0] > pts[i0, 0]
        or (pts[i, 0] == pts[i0, 0] and pts[i, 1] < pts[i0, 1])):
      i0 = i
  hull = []
  ih = i0
  while True:
    hull.append(ih)
    ie = 0
    for j in range(1, n):
      if ie == ih:
        ie = j
        continue
      r = pts[ie] - pts[ih]
      v = pts[j] - pts[ih]
      c = float(r[0] * v[1] - r[1] * v[0])
      if c < 0.0 or (c == 0.0 and v @ v > r @ r):
        ie = j
    ih = ie
    if ie == i0:
      break
  return pts[hull]


def poly_normals(verts: np.ndarray) -> np.ndarray:
  """Outward edge normals of a CCW polygon; normal[i] is for edge verts[i]->verts[i+1]."""
  nxt = np.roll(verts, -1, axis=0)
  edge = nxt - verts
  n = np.stack([edge[:, 1], -edge[:, 0]], axis=-1)
  return n / np.linalg.norm(n, axis=-1, keepdims=True)


def poly_mass(verts: np.ndarray, density: float):
  """(mass, inertia-about-centroid, centroid) of a CCW convex polygon.

  Matches Box2D b2PolygonShape::ComputeMass: triangulate from the reference
  point, sum area/centroid/inertia, then shift inertia to the centroid.
  """
  verts = np.asarray(verts, dtype=np.float64)
  s = verts.mean(axis=0)  # reference point for numerical stability
  area = 0.0
  center = np.zeros(2)
  inertia = 0.0
  k_inv3 = 1.0 / 3.0
  n = len(verts)
  for i in range(n):
    e1 = verts[i] - s
    e2 = verts[(i + 1) % n] - s
    d = float(e1[0] * e2[1] - e1[1] * e2[0])
    tri_area = 0.5 * d
    area += tri_area
    center += tri_area * k_inv3 * (e1 + e2)
    intx2 = e1[0] * e1[0] + e2[0] * e1[0] + e2[0] * e2[0]
    inty2 = e1[1] * e1[1] + e2[1] * e1[1] + e2[1] * e2[1]
    inertia += (0.25 * k_inv3 * d) * (intx2 + inty2)
  center /= area
  mass = density * area
  # inertia about the reference point s -> about centroid, in world-usable form
  i_center = density * inertia - mass * float(center @ center)
  centroid = center + s
  return float(mass), float(i_center), centroid.astype(np.float64)


def circle_mass(radius: float, density: float):
  """(mass, inertia-about-center, centroid=(0,0)); matches b2CircleShape::ComputeMass."""
  mass = density * np.pi * radius * radius
  inertia = mass * 0.5 * radius * radius
  return float(mass), float(inertia), np.zeros(2)


def pad_verts(verts: np.ndarray) -> tuple[np.ndarray, int]:
  """Pad polygon vertices to MAX_VERTS by repeating the last vertex.

  Repeated vertices produce degenerate zero-length edges; collision code masks
  by count, so the padding values only need to stay inside the hull.
  """
  n = len(verts)
  assert 3 <= n <= MAX_VERTS, f'polygon vertex count {n} out of range'
  pad = np.repeat(verts[-1:], MAX_VERTS - n, axis=0)
  return np.concatenate([verts, pad], axis=0), n
