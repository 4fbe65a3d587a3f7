// One world's rigid-body substep as device functions for a group of lanes,
// stage by stage after engine/physics.py and engine/collision.py (the port's
// plain torch path):
//
//   integrate_velocities -> collide (walls, body pairs) -> match_impulses ->
//   init_constraints -> warm_start -> velocity_sweep x vel_iters ->
//   position_solve (integrate + NGS with Box2D's per-world exit) ->
//   finalize (island sleeping, warm-start writeback)
//
// Each stage keeps physics.py's float32 op order (sources build with
// --fmad=false, IEEE division and square root), so a world here follows the
// plain version up to the order of a few sums and cosf/sinf against
// torch.cos/torch.sin. Topology and constants come from the SpecF/SpecI
// tables (filled by engine/mega.py), sized by compile-time maxima that cover
// the whole env zoo. Two kernels include this header: mega_rollout.cu runs
// every stage, and batched_solver.cu runs velocity_solve and position_solve
// on a SolveBundle that physics.py's plain presolve built; an edit of those
// two stages moves both kernels.
//
// A world is a group of G lanes (a cooperative_groups tile of 4, 8, 16 or 32
// lanes, G >= the spec's bodies), and lane i owns body i. The stages that
// the plain version runs over bodies at once run on every lane at once:
// velocity integration and damping, the wall narrowphase and its constraint
// init, the wall block of each velocity sweep and of each NGS iteration
// (sequential over walls within the lane), position integration, the
// warm-start sums (each lane adds its own body's terms in the plain order)
// and the sleep test. Pair narrowphase and pair and joint init run on lanes
// by pair or joint index. The chains the plain version runs slot by slot
// (the joint and pair blocks of a sweep and of an NGS iteration) run on the
// group's lane 0, reading and writing the bodies' velocities and poses in
// shared memory. The sweep's largest impulse delta, the NGS's least
// separation and the island minimum are max/min reductions over the group,
// which no order changes, so every world keeps its own exits. Lanes >= n
// compute nothing and write nothing; they only join the group's syncs and
// reductions, and no sync spans more than the group's own lanes.
//
// Where the state lives: the lane's own wall contacts (WallC, MW of them)
// in its registers; what other lanes index (body velocities and poses,
// masses, the pair and joint records, island labels) in the block's dynamic
// shared memory, one World slice per group, sized by the spec's own G, np
// and nj (world_words).
#pragma once

#include <math.h>

#include <cooperative_groups.h>

#define PHYS_FN __device__ __forceinline__

namespace phys {

namespace cg = cooperative_groups;

constexpr int MB = 18;   // bodies (CrabCube)
constexpr int MJ = 16;   // joint slots
constexpr int MP = 15;   // body-pair slots
constexpr int MW = 4;    // walls
constexpr int MV = 8;    // polygon vertices (engine/geom.py MAX_VERTS)

// Box2D b2Settings constants, rounded to float32 as torch rounds a Python
// float operand of a float32 op
constexpr double kPi = 3.141592653589793;
constexpr float BAUMGARTE = 0.2f;
constexpr float LINEAR_SLOP = 0.005f;
constexpr float ANGULAR_SLOP = (float)(2.0 / 180.0 * kPi);
constexpr float MAX_LINEAR_CORRECTION = 0.2f;
constexpr float MAX_ANGULAR_CORRECTION = (float)(8.0 / 180.0 * kPi);
constexpr float VELOCITY_THRESHOLD = 1.0f;
constexpr float TIME_TO_SLEEP = 0.5f;
constexpr float LIN_SLEEP_TOL_SQ = (float)(0.01 * 0.01);
constexpr float ANG_SLEEP_TOL_SQ =
    (float)((2.0 / 180.0 * 3.14159265) * (2.0 / 180.0 * 3.14159265));
constexpr float POLY_RADIUS = 0.01f;
constexpr float TOTAL_R = (float)(2 * 0.01);          // 2 * POLY_RADIUS
constexpr float BIG = 1e9f;
constexpr float MIN_SEP_OK = (float)(-3.0 * 0.005);   // -3 * LINEAR_SLOP
constexpr float FACE_TOL = (float)(0.1 * 0.005);      // 0.1 * LINEAR_SLOP

// Per-spec tables, all float32 / int32 with no padding: engine/mega.py
// builds them field by field in this order.
struct SpecF {
  float dt, exit_tol, dtg[2];
  float inv_m[MB][2], inv_i[MB][2];      // [circle variant, polygon variant]
  float lc[MB][2][2];                    // local center per variant
  float radius[MB];
  float verts[MB][MV][2];                // polygon vertices about the com
  float normals[MB][MV][2];
  float lin_div[MB], ang_div[MB];        // 1 + dt * damping
  float w_mu[MB], w_e[MB];               // wall friction mix, restitution
  float wall_n[MW][2], wall_off[MW];
  float p_mu[MP], p_e[MP];
  float j_anchor_a[MJ][2], j_anchor_b[MJ][2];
  float j_lower[MJ], j_upper[MJ], j_cap[MJ], j_validf[MJ];
};

struct SpecI {
  int n, nw, jn, nj, np;                 // jn real joints of nj slots
  int substeps, vel_iters, pos_iters, allow_sleep, label_rounds;
  int nverts[MB];
  int pair_a[MP], pair_b[MP], pair_valid[MP];
  int j_pa[MJ], j_ch[MJ], j_limited[MJ], j_equal[MJ], j_valid[MJ];
};

// A wall contact (the lane's body, one wall): manifold and solver constants,
// in the owning lane's registers. Between substeps imp and ids hold the
// warm-start carry (0 and -1 where the point does not touch).
struct WallC {
  bool touch[2], vtouch[2], block;
  int ids[2];
  float rbx[2], rby[2];                  // contact point - com
  float lpx[2], lpy[2], rad_sub;         // for the position solve
  float nmass[2], tmass[2], bias[2], kn[2], k12;
  float imp[2][2];                       // [point][normal, tangent]
};

// A body-pair contact in shared memory (flags as int, 48 words). Between
// substeps imp and ids hold the warm-start carry, as in WallC.
struct PairC {
  int touch[2], vtouch[2], block, ids[2], mtype;
  float nx, ny;
  float rax[2], ray[2], rbx[2], rby[2];
  float lnx, lny, lppx, lppy, lpsx[2], lpsy[2], rad_sub;
  float nmass[2], tmass[2], bias[2], kn[2], k12;
  float imA, imB, iiA, iiB;
  float imp[2][2];
  float Px, Py, tA, tB;                  // warm-start impulse and torques
};

// A joint slot in shared memory (18 words): the substep's constants, the
// warm-start carry (imp, mot, lim, state), the reference angle, the motor
// speed of this step and of the last.
struct JointC {
  float rax, ray, rbx, rby, axmass, mA, mB, iA, iB;
  int state;
  float imp[2], mot, lim;
  float ref, prev_motor, ms;
  int mchg;                              // motor speed changed this step
};

// One world's slice of the block's dynamic shared memory, in 4-byte words:
// BODY_ARRAYS arrays of G words (lane i's body at index i), np pair records,
// nj joint records, padded so that world_words % 32 == G % 32. The slices of
// the 32 / G worlds of a warp then start G banks apart, so neither the
// body-parallel stages (lane (k, i) at word k * world_words + f * G + i) nor
// the lane-0 chains (one lane per world, at the same field offset) put two
// lanes of a warp on one bank. engine/mega.py mirrors these three constants
// and the formula.
constexpr int BODY_ARRAYS = 18;
constexpr int PAIR_WORDS = 48;
constexpr int JOINT_WORDS = 18;
static_assert(sizeof(PairC) == PAIR_WORDS * 4, "PairC is 48 words");
static_assert(sizeof(JointC) == JOINT_WORDS * 4, "JointC is 18 words");

__host__ __device__ inline int world_words(int G, int np, int nj) {
  const int w = BODY_ARRAYS * G + PAIR_WORDS * np + JOINT_WORDS * nj;
  return w + ((G % 32) - w % 32 + 32) % 32;
}

template <unsigned G>
struct World {
  float* b;                              // the BODY_ARRAYS arrays
  PairC* pc;
  JointC* jc;
  // the solver's velocities and the position solve's poses
  PHYS_FN float& vx(int i) const { return b[i]; }
  PHYS_FN float& vy(int i) const { return b[G + i]; }
  PHYS_FN float& w(int i) const { return b[2 * G + i]; }
  PHYS_FN float& cx(int i) const { return b[3 * G + i]; }
  PHYS_FN float& cy(int i) const { return b[4 * G + i]; }
  PHYS_FN float& a(int i) const { return b[5 * G + i]; }
  // the state's poses (the substep's start)
  PHYS_FN float& sx(int i) const { return b[6 * G + i]; }
  PHYS_FN float& sy(int i) const { return b[7 * G + i]; }
  PHYS_FN float& sa(int i) const { return b[8 * G + i]; }
  PHYS_FN float& cs(int i) const { return b[9 * G + i]; }
  PHYS_FN float& sn(int i) const { return b[10 * G + i]; }
  PHYS_FN float& im(int i) const { return b[11 * G + i]; }
  PHYS_FN float& ii(int i) const { return b[12 * G + i]; }
  PHYS_FN float& lcx(int i) const { return b[13 * G + i]; }
  PHYS_FN float& lcy(int i) const { return b[14 * G + i]; }
  PHYS_FN float& sleep(int i) const { return b[15 * G + i]; }
  PHYS_FN int& circ(int i) const { return reinterpret_cast<int*>(b)[16 * G + i]; }
  PHYS_FN int& label(int i) const { return reinterpret_cast<int*>(b)[17 * G + i]; }
};

// The slice of group `slot` of the block.
template <unsigned G>
PHYS_FN World<G> world_view(float* smem, int slot, int np, int nj) {
  World<G> W;
  W.b = smem + (long)slot * world_words(G, np, nj);
  W.pc = reinterpret_cast<PairC*>(W.b + BODY_ARRAYS * G);
  W.jc = reinterpret_cast<JointC*>(W.b + BODY_ARRAYS * G + PAIR_WORDS * np);
  return W;
}

template <unsigned G>
using Group = cg::thread_block_tile<G>;

// Max / min over the group's lanes; exact in any order.
template <unsigned G>
PHYS_FN float group_max(const Group<G>& g, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v = fmaxf(v, g.shfl_xor(v, o));
  return v;
}

template <unsigned G>
PHYS_FN float group_min(const Group<G>& g, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v = fminf(v, g.shfl_xor(v, o));
  return v;
}

// A body's pose at the substep's start, for the narrowphase.
struct Pose {
  float cx, cy, cs, sn;
  bool circ;
};

// ---- small vector helpers (physics.py / collision.py op order) -------------

PHYS_FN float dot2(float ax, float ay, float bx, float by) {
  return ax * bx + ay * by;
}

PHYS_FN float cross_vv(float ax, float ay, float bx, float by) {
  return ax * by - ay * bx;
}

// R(angle) @ x and R(angle)^T @ x
PHYS_FN void rot(float c, float s, float x, float y, float& ox, float& oy) {
  ox = c * x - s * y;
  oy = s * x + c * y;
}

PHYS_FN void rot_t(float c, float s, float x, float y, float& ox, float& oy) {
  ox = c * x + s * y;
  oy = -s * x + c * y;
}

PHYS_FN float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---- narrowphase (collision.py) -------------------------------------------

struct Manifold {
  float nx, ny, px[2], py[2], sep[2];
  bool touch[2];
  int ids[2], mtype;
  float lnx, lny, lppx, lppy, lpsx[2], lpsy[2], rad_sub;
};

// World vertices and normals of body b's polygon variant.
PHYS_FN void world_poly(const SpecF& F, int b, float cx, float cy, float cs,
                        float sn, int nv, float* wvx, float* wvy, float* wnx,
                        float* wny) {
  for (int v = 0; v < nv; ++v) {
    float rx, ry;
    rot(cs, sn, F.verts[b][v][0], F.verts[b][v][1], rx, ry);
    wvx[v] = cx + rx;
    wvy[v] = cy + ry;
    rot(cs, sn, F.normals[b][v][0], F.normals[b][v][1], wnx[v], wny[v]);
  }
}

PHYS_FN void collide_circles(float ax, float ay, float ra, float bx, float by,
                             float rb, Manifold& m) {
  const float dx = bx - ax, dy = by - ay;
  const float dist = sqrtf(dx * dx + dy * dy);
  const float dd = fmaxf(dist, 1e-9f);
  const bool ok = dist > 1e-9f;
  m.nx = ok ? dx / dd : 0.0f;
  m.ny = ok ? dy / dd : 1.0f;
  m.sep[0] = (dist - ra) - rb;
  m.sep[1] = BIG;
  m.touch[0] = m.sep[0] <= 0.0f;
  m.touch[1] = false;
  const float px = 0.5f * ((ax + ra * m.nx) + (bx - rb * m.nx));
  const float py = 0.5f * ((ay + ra * m.ny) + (by - rb * m.ny));
  m.px[0] = m.px[1] = px;
  m.py[0] = m.py[1] = py;
  m.ids[0] = m.ids[1] = 0;
  m.mtype = 0;
  m.lnx = m.lny = m.lppx = m.lppy = 0.0f;
  m.lpsx[0] = m.lpsx[1] = m.lpsy[0] = m.lpsy[1] = 0.0f;
  m.rad_sub = ra + rb;
}

// Polygon A (world verts/normals) against circle B: face-A manifold with a
// single point (b2CollidePolygonAndCircle).
PHYS_FN void collide_poly_circle(const float* wvx, const float* wvy,
                                 const float* wnx, const float* wny, int nv,
                                 float cax, float cay, float csA, float snA,
                                 float cbx, float cby, float rb, Manifold& m) {
  int best = 0;
  float max_sep = 0.0f;
  for (int v = 0; v < nv; ++v) {
    const float s = dot2(wnx[v], wny[v], cbx - wvx[v], cby - wvy[v]);
    if (v == 0 || s > max_sep) { max_sep = s; best = v; }
  }
  const int nxt = best + 1 < nv ? best + 1 : 0;
  const float v1x = wvx[best], v1y = wvy[best], v2x = wvx[nxt], v2y = wvy[nxt];
  const float u1 = dot2(cbx - v1x, cby - v1y, v2x - v1x, v2y - v1y);
  const float u2 = dot2(cbx - v2x, cby - v2y, v1x - v2x, v1y - v2y);
  const float fnx = wnx[best], fny = wny[best];
  const float d1x = cbx - v1x, d1y = cby - v1y;
  const float l1 = sqrtf(d1x * d1x + d1y * d1y);
  const float d2x = cbx - v2x, d2y = cby - v2y;
  const float l2 = sqrtf(d2x * d2x + d2y * d2y);
  const bool inside = max_sep < 1e-9f;
  const bool use_v1 = !inside && u1 <= 0.0f;
  const bool use_v2 = !inside && u2 <= 0.0f && !use_v1;
  float nx, ny, ppx, ppy, sep_raw;
  if (use_v1) {
    const float l = fmaxf(l1, 1e-9f);
    nx = l1 > 1e-9f ? d1x / l : fnx;
    ny = l1 > 1e-9f ? d1y / l : fny;
    ppx = v1x; ppy = v1y; sep_raw = l1;
  } else if (use_v2) {
    const float l = fmaxf(l2, 1e-9f);
    nx = l2 > 1e-9f ? d2x / l : fnx;
    ny = l2 > 1e-9f ? d2y / l : fny;
    ppx = v2x; ppy = v2y; sep_raw = l2;
  } else {
    nx = fnx; ny = fny;
    ppx = 0.5f * (v1x + v2x);
    ppy = 0.5f * (v1y + v2y);
    sep_raw = dot2(cbx - ppx, cby - ppy, fnx, fny);
  }
  m.nx = nx; m.ny = ny;
  m.sep[0] = (sep_raw - rb) - POLY_RADIUS;
  m.sep[1] = BIG;
  m.touch[0] = m.sep[0] <= 0.0f;
  m.touch[1] = false;
  const float px = 0.5f * ((cbx - sep_raw * nx) + (cbx - rb * nx));
  const float py = 0.5f * ((cby - sep_raw * ny) + (cby - rb * ny));
  m.px[0] = m.px[1] = px;
  m.py[0] = m.py[1] = py;
  m.ids[0] = m.ids[1] = 0;
  m.mtype = 1;
  rot_t(csA, snA, nx, ny, m.lnx, m.lny);
  rot_t(csA, snA, ppx - cax, ppy - cay, m.lppx, m.lppy);
  m.lpsx[0] = m.lpsx[1] = m.lpsy[0] = m.lpsy[1] = 0.0f;
  m.rad_sub = rb + POLY_RADIUS;
}

// Max over A's faces of min over B's verts of the face-plane separation.
PHYS_FN float max_separation(const float* avx, const float* avy,
                             const float* anx, const float* any, int nva,
                             const float* bvx, const float* bvy, int nvb,
                             int& best) {
  float best_sep = 0.0f;
  best = 0;
  for (int k = 0; k < nva; ++k) {
    const float off = dot2(anx[k], any[k], avx[k], avy[k]);
    float m = 0.0f;
    for (int v = 0; v < nvb; ++v) {
      const float d = dot2(anx[k], any[k], bvx[v], bvy[v]) - off;
      m = v == 0 ? d : fminf(m, d);
    }
    if (k == 0 || m > best_sep) { best_sep = m; best = k; }
  }
  return best_sep;
}

// b2ClipSegmentToLine: keep the sub-segment with dot(n, p) - offset <= 0.
PHYS_FN bool clip_segment(float& p1x, float& p1y, float& p2x, float& p2y,
                          int& id1, int& id2, float nx, float ny,
                          float offset) {
  const float d1 = dot2(nx, ny, p1x, p1y) - offset;
  const float d2 = dot2(nx, ny, p2x, p2y) - offset;
  const float den = d1 - d2;
  const float t = d1 / (fabsf(den) > 1e-12f ? den : 1e-12f);
  const float pmx = p1x + t * (p2x - p1x), pmy = p1y + t * (p2y - p1y);
  const int i1 = d1 <= 0.0f ? id1 : id2 + 16;
  const int i2 = d2 <= 0.0f ? id2 : id1 + 16;
  if (!(d1 <= 0.0f)) { p1x = pmx; p1y = pmy; }
  if (!(d2 <= 0.0f)) { p2x = pmx; p2y = pmy; }
  id1 = i1;
  id2 = i2;
  return fminf(d1, d2) <= 0.0f;
}

// Clip the incident face of `inc` against reference face `ref_face` of ref.
PHYS_FN void clip_face(const float* rvx, const float* rvy, const float* rnx,
                       const float* rny, int nvr, int ref_face, float crx,
                       float cry, float csr, float snr, const float* ivx,
                       const float* ivy, const float* inx, const float* iny,
                       int nvi, float cix, float ciy, float csi, float sni,
                       bool flip, Manifold& m) {
  int i2 = (ref_face + 1) % MV;
  i2 = i2 < nvr ? i2 : 0;
  const float v1x = rvx[ref_face], v1y = rvy[ref_face];
  const float v2x = rvx[i2], v2y = rvy[i2];
  const float nrx = rnx[ref_face], nry = rny[ref_face];
  int inc = 0;
  float best = 0.0f;
  for (int v = 0; v < nvi; ++v) {
    const float d = dot2(inx[v], iny[v], nrx, nry);
    if (v == 0 || d < best) { best = d; inc = v; }
  }
  int j2 = (inc + 1) % MV;
  j2 = j2 < nvi ? j2 : 0;
  float q1x = ivx[inc], q1y = ivy[inc], q2x = ivx[j2], q2y = ivy[j2];
  int id1 = inc, id2 = j2;
  float tx = v2x - v1x, ty = v2y - v1y;
  const float tl = fmaxf(sqrtf(tx * tx + ty * ty), 1e-9f);
  tx = tx / tl;
  ty = ty / tl;
  const bool ok1 = clip_segment(q1x, q1y, q2x, q2y, id1, id2, -tx, -ty,
                                -dot2(tx, ty, v1x, v1y));
  const bool ok2 = clip_segment(q1x, q1y, q2x, q2y, id1, id2, tx, ty,
                                dot2(tx, ty, v2x, v2y));
  const bool ok = ok1 && ok2;
  const float qx[2] = {q1x, q2x}, qy[2] = {q1y, q2y};
  const int ids[2] = {id1, id2};
  for (int k = 0; k < 2; ++k) {
    const float sep = dot2(nrx, nry, qx[k] - v1x, qy[k] - v1y) - TOTAL_R;
    m.sep[k] = sep;
    m.touch[k] = ok && sep <= 0.0f;
    const float h = 0.5f * (sep + TOTAL_R);
    m.px[k] = qx[k] - h * nrx;
    m.py[k] = qy[k] - h * nry;
    m.ids[k] = ids[k] + (flip ? 64 : 0);
    rot_t(csi, sni, qx[k] - cix, qy[k] - ciy, m.lpsx[k], m.lpsy[k]);
  }
  m.nx = flip ? -nrx : nrx;
  m.ny = flip ? -nry : nry;
  m.mtype = flip ? 2 : 1;
  rot_t(csr, snr, nrx, nry, m.lnx, m.lny);
  rot_t(csr, snr, 0.5f * (v1x + v2x) - crx, 0.5f * (v1y + v2y) - cry,
        m.lppx, m.lppy);
  m.rad_sub = TOTAL_R;
}

// Manifold of the body pair (a, b), dispatched on the per-world shapes.
PHYS_FN void collide_pair(const SpecF& F, const SpecI& I, int a,
                          const Pose& A, int b, const Pose& Bp, Manifold& m) {
  const bool ca = A.circ, cb = Bp.circ;
  if (ca && cb) {
    collide_circles(A.cx, A.cy, F.radius[a], Bp.cx, Bp.cy, F.radius[b], m);
    return;
  }
  float avx[MV], avy[MV], anx[MV], any[MV], bvx[MV], bvy[MV], bnx[MV], bny[MV];
  const int nva = I.nverts[a], nvb = I.nverts[b];
  if (!ca) world_poly(F, a, A.cx, A.cy, A.cs, A.sn, nva, avx, avy, anx, any);
  if (!cb) world_poly(F, b, Bp.cx, Bp.cy, Bp.cs, Bp.sn, nvb, bvx, bvy, bnx, bny);
  if (ca) {            // circle A, polygon B: B's face manifold, flipped
    collide_poly_circle(bvx, bvy, bnx, bny, nvb, Bp.cx, Bp.cy, Bp.cs, Bp.sn,
                        A.cx, A.cy, F.radius[a], m);
    m.nx = -m.nx;
    m.ny = -m.ny;
    m.mtype = 2;
    return;
  }
  if (cb) {
    collide_poly_circle(avx, avy, anx, any, nva, A.cx, A.cy, A.cs, A.sn,
                        Bp.cx, Bp.cy, F.radius[b], m);
    return;
  }
  int fa, fb;
  const float sep_a = max_separation(avx, avy, anx, any, nva, bvx, bvy, nvb, fa);
  const float sep_b = max_separation(bvx, bvy, bnx, bny, nvb, avx, avy, nva, fb);
  const bool no_contact = sep_a > TOTAL_R || sep_b > TOTAL_R;
  if (sep_b > sep_a + FACE_TOL)
    clip_face(bvx, bvy, bnx, bny, nvb, fb, Bp.cx, Bp.cy, Bp.cs, Bp.sn, avx,
              avy, anx, any, nva, A.cx, A.cy, A.cs, A.sn, true, m);
  else
    clip_face(avx, avy, anx, any, nva, fa, A.cx, A.cy, A.cs, A.sn, bvx, bvy,
              bnx, bny, nvb, Bp.cx, Bp.cy, Bp.cs, Bp.sn, false, m);
  m.touch[0] = m.touch[0] && !no_contact;
  m.touch[1] = m.touch[1] && !no_contact;
}

// Body i against the inward half-plane wi (collide_wall). The two deepest
// vertices are picked in one pass over the polygon (ties to the lower index,
// a stable sort), carrying their world positions along.
PHYS_FN void collide_wall(const SpecF& F, const SpecI& I, int i,
                          const Pose& P, int wi, Manifold& m) {
  const float nx = F.wall_n[wi][0], ny = F.wall_n[wi][1];
  const float off = F.wall_off[wi];
  const float cx = P.cx, cy = P.cy;
  if (P.circ) {
    const float r = F.radius[i];
    m.sep[0] = ((dot2(nx, ny, cx, cy) - off) - r) - POLY_RADIUS;
    m.sep[1] = BIG;
    m.px[0] = m.px[1] = cx - r * nx;
    m.py[0] = m.py[1] = cy - r * ny;
    m.ids[0] = m.ids[1] = 0;
    m.lpsx[0] = m.lpsx[1] = m.lpsy[0] = m.lpsy[1] = 0.0f;
    m.rad_sub = r + POLY_RADIUS;
  } else {
    const int nv = I.nverts[i];
    int i1 = -1, i2 = -1;
    float s1 = 0.0f, s2 = 0.0f, x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f;
#pragma unroll
    for (int v = 0; v < MV; ++v) {
      if (v >= nv) break;
      float rx, ry;
      rot(P.cs, P.sn, F.verts[i][v][0], F.verts[i][v][1], rx, ry);
      const float wx = cx + rx, wy = cy + ry;
      const float s = (dot2(wx, wy, nx, ny) - off) - TOTAL_R;
      if (i1 < 0 || s < s1) {
        i2 = i1; s2 = s1; x2 = x1; y2 = y1;
        i1 = v; s1 = s; x1 = wx; y1 = wy;
      } else if (i2 < 0 || s < s2) {
        i2 = v; s2 = s; x2 = wx; y2 = wy;
      }
    }
    m.sep[0] = s1;
    m.sep[1] = s2;
    m.px[0] = x1; m.py[0] = y1; m.ids[0] = i1;
    m.px[1] = x2; m.py[1] = y2; m.ids[1] = i2;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      rot_t(P.cs, P.sn, m.px[k] - cx, m.py[k] - cy, m.lpsx[k], m.lpsy[k]);
    m.rad_sub = TOTAL_R;
  }
  m.touch[0] = m.sep[0] <= 0.0f;
  m.touch[1] = m.sep[1] <= 0.0f;
}

// Warm start: carry accumulated impulses of persisting contact ids.
PHYS_FN void match_impulses(const int* new_ids, const bool* touch,
                            const int* old_ids, const float (*old_imp)[2],
                            float (*imp)[2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float e0 = new_ids[k] == old_ids[0] ? 1.0f : 0.0f;
      const float e1 = new_ids[k] == old_ids[1] ? 1.0f : 0.0f;
      imp[k][q] = touch[k] ? e0 * old_imp[0][q] + e1 * old_imp[1][q] : 0.0f;
    }
}

// ---- the solver stages (physics.py) ----------------------------------------

// Box2D's 2-point normal block solve (_block_lcp): impulse deltas.
PHYS_FN void block_lcp(float b1, float b2, float a1, float a2, float k11,
                       float k22, float k12, float nm1, float nm2, float& d1,
                       float& d2) {
  const float b1p = b1 - (k11 * a1 + k12 * a2);
  const float b2p = b2 - (k12 * a1 + k22 * a2);
  const float det = k11 * k22 - k12 * k12;
  const float idet = fabsf(det) > 1e-12f ? 1.0f / (det == 0.0f ? 1.0f : det)
                                         : 0.0f;
  const float x1_1 = -(k22 * b1p - k12 * b2p) * idet;
  const float x2_1 = -(k11 * b2p - k12 * b1p) * idet;
  const float x1_2 = -nm1 * b1p;
  const float x2_3 = -nm2 * b2p;
  float x1, x2;
  if (x1_1 >= 0.0f && x2_1 >= 0.0f) { x1 = x1_1; x2 = x2_1; }
  else if (x1_2 >= 0.0f && k12 * x1_2 + b2p >= 0.0f) { x1 = x1_2; x2 = 0.0f; }
  else if (x2_3 >= 0.0f && k12 * x2_3 + b1p >= 0.0f) { x1 = 0.0f; x2 = x2_3; }
  else if (b1p >= 0.0f && b2p >= 0.0f) { x1 = 0.0f; x2 = 0.0f; }
  else { x1 = a1; x2 = a2; }
  d1 = x1 - a1;
  d2 = x2 - a2;
}

// Box2D 2.3's coupled revolute limit + point velocity solve (_joint_block).
PHYS_FN void joint_block(int state, float cd1x, float cd1y, float cd2,
                         float jlim, float k11, float k12, float k13,
                         float k22, float k23, float k33, float& dx,
                         float& dy, float& dz) {
  const float a11 = k22 * k33 - k23 * k23;
  const float a12 = k13 * k23 - k12 * k33;
  const float a13 = k12 * k23 - k13 * k22;
  const float a22 = k11 * k33 - k13 * k13;
  const float a23 = k13 * k12 - k11 * k23;
  const float a33 = k11 * k22 - k12 * k12;
  float det3 = k11 * a11 + k12 * a12 + k13 * a13;
  det3 = fabsf(det3) > 1e-12f ? det3 : 1.0f;
  float det2 = k11 * k22 - k12 * k12;
  det2 = fabsf(det2) > 1e-12f ? det2 : 1.0f;
  if (state > 0) {
    const float ix = -(a11 * cd1x + a12 * cd1y + a13 * cd2) / det3;
    const float iy = -(a12 * cd1x + a22 * cd1y + a23 * cd2) / det3;
    const float iz = -(a13 * cd1x + a23 * cd1y + a33 * cd2) / det3;
    const float new_z = jlim + iz;
    const bool clamp = (state == 1 && new_z < 0.0f) || (state == 2 && new_z > 0.0f);
    if (clamp) {
      const float r1 = -cd1x + jlim * k13;
      const float r2 = -cd1y + jlim * k23;
      dx = (k22 * r1 - k12 * r2) / det2;
      dy = (k11 * r2 - k12 * r1) / det2;
      dz = -jlim;
    } else {
      dx = ix; dy = iy; dz = iz;
    }
  } else {
    dx = -(k22 * cd1x - k12 * cd1y) / det2;
    dy = -(k11 * cd1y - k12 * cd1x) / det2;
    dz = 0.0f;
  }
}


// ---- the stages, for one world's group of lanes ----------------------------

// Per-episode body constants from the shape flags (body_inv_mass,
// local_center), lane i for body i.
template <unsigned G>
PHYS_FN void body_constants(const Group<G>& g, const SpecF& F, const SpecI& I,
                            const World<G>& W) {
  const int i = g.thread_rank();
  if (i < I.n) {
    const int v = W.circ(i) ? 0 : 1;
    W.im(i) = F.inv_m[i][v];
    W.ii(i) = F.inv_i[i][v];
    W.lcx(i) = F.lc[i][v][0];
    W.lcy(i) = F.lc[i][v][1];
  }
}

// The lane's own body between substeps: the state's velocities.
struct Own {
  float vx, vy, w;
};

// Steps 1-4 (_presolve up to the warm start): integrate velocities, wall
// narrowphase and constraint init on every body's lane; then pair
// narrowphase and init by pair index, joint init by joint index.
template <unsigned G>
PHYS_FN void presolve(const Group<G>& g, const SpecF& F, const SpecI& I,
                      const World<G>& W, const Own& o, WallC (&wc)[MW]) {
  const int i = g.thread_rank();
  if (i < I.n) {
    const float vx = (o.vx + F.dtg[0]) / F.lin_div[i];
    const float vy = (o.vy + F.dtg[1]) / F.lin_div[i];
    const float w = o.w / F.ang_div[i];
    W.vx(i) = vx;
    W.vy(i) = vy;
    W.w(i) = w;
    const float sa = W.sa(i);
    const Pose P = {W.sx(i), W.sy(i), cosf(sa), sinf(sa), W.circ(i) != 0};
    W.cs(i) = P.cs;
    W.sn(i) = P.sn;
    // walls: the static wall is body A with zero mass
    const float im = W.im(i), ii = W.ii(i);
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= I.nw) break;
      WallC& C = wc[wi];
      Manifold m;
      collide_wall(F, I, i, P, wi, m);
      const float nx = F.wall_n[wi][0], ny = F.wall_n[wi][1];
      const float tx = ny, ty = -nx;
      const int old_ids[2] = {C.ids[0], C.ids[1]};
      const float old_imp[2][2] = {{C.imp[0][0], C.imp[0][1]},
                                   {C.imp[1][0], C.imp[1][1]}};
      float rn[2], kt[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        C.touch[k] = m.touch[k];
        C.ids[k] = m.ids[k];
        C.rbx[k] = m.px[k] - P.cx;
        C.rby[k] = m.py[k] - P.cy;
        C.lpx[k] = m.lpsx[k];
        C.lpy[k] = m.lpsy[k];
        rn[k] = cross_vv(C.rbx[k], C.rby[k], nx, ny);
        C.kn[k] = im + ii * (rn[k] * rn[k]);
        const float rt = cross_vv(C.rbx[k], C.rby[k], tx, ty);
        kt[k] = im + ii * (rt * rt);
      }
      C.rad_sub = m.rad_sub;
      match_impulses(C.ids, C.touch, old_ids, old_imp, C.imp);
      C.k12 = im + ii * rn[0] * rn[1];
      const float det = C.kn[0] * C.kn[1] - C.k12 * C.k12;
      const bool cond = C.kn[0] * C.kn[0] < 1000.0f * det;
      const bool both = C.touch[0] && C.touch[1];
      C.block = both && cond;
      C.vtouch[0] = C.touch[0];
      C.vtouch[1] = C.touch[1] && !(both && !cond);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool vt = C.vtouch[k];
        if (!vt) C.imp[k][0] = C.imp[k][1] = 0.0f;
        C.nmass[k] = vt ? 1.0f / fmaxf(C.kn[k], 1e-12f) : 0.0f;
        C.tmass[k] = vt ? 1.0f / fmaxf(kt[k], 1e-12f) : 0.0f;
        const float dvx = vx + (-w) * C.rby[k];
        const float dvy = vy + w * C.rbx[k];
        const float vn0 = dot2(dvx, dvy, nx, ny);
        C.bias[k] = vn0 < -VELOCITY_THRESHOLD ? (-F.w_e[i]) * vn0 : 0.0f;
      }
    }
  }
  g.sync();   // pairs and joints read other bodies' velocities and cos/sin
  // body pairs, by pair index
  for (int p = i; p < I.np; p += G) {
    PairC& C = W.pc[p];
    if (!I.pair_valid[p]) {
      C.touch[0] = C.touch[1] = C.vtouch[0] = C.vtouch[1] = C.block = 0;
      C.ids[0] = C.ids[1] = 0;
      continue;
    }
    const int a = I.pair_a[p], b = I.pair_b[p];
    const Pose A = {W.sx(a), W.sy(a), W.cs(a), W.sn(a), W.circ(a) != 0};
    const Pose Bp = {W.sx(b), W.sy(b), W.cs(b), W.sn(b), W.circ(b) != 0};
    Manifold m;
    collide_pair(F, I, a, A, b, Bp, m);
    C.nx = m.nx; C.ny = m.ny;
    C.mtype = m.mtype;
    C.lnx = m.lnx; C.lny = m.lny; C.lppx = m.lppx; C.lppy = m.lppy;
    C.rad_sub = m.rad_sub;
    const float tx = m.ny, ty = -m.nx;
    C.imA = W.im(a); C.imB = W.im(b);
    C.iiA = W.ii(a); C.iiB = W.ii(b);
    const int old_ids[2] = {C.ids[0], C.ids[1]};
    const float old_imp[2][2] = {{C.imp[0][0], C.imp[0][1]},
                                 {C.imp[1][0], C.imp[1][1]}};
    bool touch[2];
    int ids[2];
    float imp[2][2], rnA[2], rnB[2], kt[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      touch[k] = m.touch[k];
      ids[k] = m.ids[k];
      C.touch[k] = touch[k];
      C.ids[k] = ids[k];
      C.lpsx[k] = m.lpsx[k]; C.lpsy[k] = m.lpsy[k];
      C.rax[k] = m.px[k] - A.cx; C.ray[k] = m.py[k] - A.cy;
      C.rbx[k] = m.px[k] - Bp.cx; C.rby[k] = m.py[k] - Bp.cy;
      rnA[k] = cross_vv(C.rax[k], C.ray[k], m.nx, m.ny);
      rnB[k] = cross_vv(C.rbx[k], C.rby[k], m.nx, m.ny);
      C.kn[k] = ((C.imA + C.imB) + C.iiA * (rnA[k] * rnA[k]))
          + C.iiB * (rnB[k] * rnB[k]);
      const float rtA = cross_vv(C.rax[k], C.ray[k], tx, ty);
      const float rtB = cross_vv(C.rbx[k], C.rby[k], tx, ty);
      kt[k] = ((C.imA + C.imB) + C.iiA * (rtA * rtA)) + C.iiB * (rtB * rtB);
    }
    match_impulses(ids, touch, old_ids, old_imp, imp);
    C.k12 = ((C.imA + C.imB) + C.iiA * rnA[0] * rnA[1]) + C.iiB * rnB[0] * rnB[1];
    const float det = C.kn[0] * C.kn[1] - C.k12 * C.k12;
    const bool cond = C.kn[0] * C.kn[0] < 1000.0f * det;
    const bool both = touch[0] && touch[1];
    C.block = both && cond;
    const bool vtouch[2] = {touch[0], touch[1] && !(both && !cond)};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool vt = vtouch[k];
      C.vtouch[k] = vt;
      if (!vt) imp[k][0] = imp[k][1] = 0.0f;
      C.imp[k][0] = imp[k][0];
      C.imp[k][1] = imp[k][1];
      C.nmass[k] = vt ? 1.0f / fmaxf(C.kn[k], 1e-12f) : 0.0f;
      C.tmass[k] = vt ? 1.0f / fmaxf(kt[k], 1e-12f) : 0.0f;
      const float dvx = ((W.vx(b) + (-W.w(b)) * C.rby[k]) - W.vx(a))
          - (-W.w(a)) * C.ray[k];
      const float dvy = ((W.vy(b) + W.w(b) * C.rbx[k]) - W.vy(a))
          - W.w(a) * C.rax[k];
      const float vn0 = dot2(dvx, dvy, m.nx, m.ny);
      C.bias[k] = vn0 < -VELOCITY_THRESHOLD ? (-F.p_e[p]) * vn0 : 0.0f;
    }
  }
  // joints, by joint index
  for (int j = i; j < I.nj; j += G) {
    JointC& J = W.jc[j];
    const int pa = I.j_pa[j], ch = I.j_ch[j];
    const float vf = F.j_validf[j];
    rot(W.cs(pa), W.sn(pa), F.j_anchor_a[j][0] - W.lcx(pa),
        F.j_anchor_a[j][1] - W.lcy(pa), J.rax, J.ray);
    rot(W.cs(ch), W.sn(ch), F.j_anchor_b[j][0] - W.lcx(ch),
        F.j_anchor_b[j][1] - W.lcy(ch), J.rbx, J.rby);
    J.mA = W.im(pa); J.mB = W.im(ch);
    J.iA = W.ii(pa); J.iB = W.ii(ch);
    const float raw = J.iA + J.iB;
    J.axmass = (raw > 0.0f ? 1.0f / fmaxf(raw, 1e-12f) : 0.0f) * vf;
    const float ang = (W.sa(ch) - W.sa(pa)) - J.ref;
    int st = 0;
    if (I.j_limited[j] && I.j_valid[j]) {
      if (I.j_equal[j]) st = 3;
      else if (ang <= F.j_lower[j]) st = 1;
      else if (ang >= F.j_upper[j]) st = 2;
    }
    J.lim = (st == J.state ? J.lim : 0.0f) * vf;
    J.state = st;
    J.mot = J.mot * vf;
    J.imp[0] = J.imp[0] * vf;
    J.imp[1] = J.imp[1] * vf;
  }
  g.sync();
}

// Step 5: warm start. Each body's lane adds its own terms in _presolve's
// order: walls; pairs on A, then on B; joints on the parent, then on the
// child (velocities and angular velocities are separate sums).
template <unsigned G>
PHYS_FN void warm_start(const Group<G>& g, const SpecF& F, const SpecI& I,
                        const World<G>& W, const WallC (&wc)[MW]) {
  const int i = g.thread_rank();
  for (int p = i; p < I.np; p += G) {
    PairC& C = W.pc[p];
    if (!I.pair_valid[p]) continue;
    const float tx = C.ny, ty = -C.nx;
    float sx = 0.0f, sy = 0.0f, sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float Px = C.imp[k][0] * C.nx + C.imp[k][1] * tx;
      const float Py = C.imp[k][0] * C.ny + C.imp[k][1] * ty;
      const float ca = cross_vv(C.rax[k], C.ray[k], Px, Py);
      const float cb = cross_vv(C.rbx[k], C.rby[k], Px, Py);
      sx = k ? sx + Px : Px;
      sy = k ? sy + Py : Py;
      sa = k ? sa + ca : ca;
      sb = k ? sb + cb : cb;
    }
    C.Px = sx; C.Py = sy; C.tA = sa; C.tB = sb;
  }
  g.sync();
  if (i < I.n) {
    const float im = W.im(i), ii = W.ii(i);
    float px = 0.0f, py = 0.0f, tq = 0.0f;
    bool first = true;
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= I.nw) break;
      const WallC& C = wc[wi];
      const float nx = F.wall_n[wi][0], ny = F.wall_n[wi][1];
      const float tx = ny, ty = -nx;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float Px = C.imp[k][0] * nx + C.imp[k][1] * tx;
        const float Py = C.imp[k][0] * ny + C.imp[k][1] * ty;
        const float t = cross_vv(C.rbx[k], C.rby[k], Px, Py);
        px = first ? Px : px + Px;
        py = first ? Py : py + Py;
        tq = first ? t : tq + t;
        first = false;
      }
    }
    float vx = W.vx(i) + im * px;
    float vy = W.vy(i) + im * py;
    float w = W.w(i) + ii * tq;
    for (int p = 0; p < I.np; ++p) {
      if (!I.pair_valid[p] || I.pair_a[p] != i) continue;
      vx = vx + (-im) * W.pc[p].Px;
      vy = vy + (-im) * W.pc[p].Py;
    }
    for (int p = 0; p < I.np; ++p) {
      if (!I.pair_valid[p] || I.pair_b[p] != i) continue;
      vx = vx + im * W.pc[p].Px;
      vy = vy + im * W.pc[p].Py;
    }
    for (int p = 0; p < I.np; ++p) {
      if (!I.pair_valid[p] || I.pair_a[p] != i) continue;
      w = w + (-ii) * W.pc[p].tA;
    }
    for (int p = 0; p < I.np; ++p) {
      if (!I.pair_valid[p] || I.pair_b[p] != i) continue;
      w = w + ii * W.pc[p].tB;
    }
    for (int j = 0; j < I.jn; ++j) {
      if (I.j_pa[j] != i) continue;
      const JointC& J = W.jc[j];
      vx = vx + (-J.mA) * J.imp[0];
      vy = vy + (-J.mA) * J.imp[1];
    }
    for (int j = 0; j < I.jn; ++j) {
      if (I.j_pa[j] != i) continue;
      const JointC& J = W.jc[j];
      w = w + (-J.iA) * (cross_vv(J.rax, J.ray, J.imp[0], J.imp[1])
                         + (J.mot + J.lim));
    }
    for (int j = 0; j < I.jn; ++j) {
      if (I.j_ch[j] != i) continue;
      const JointC& J = W.jc[j];
      vx = vx + J.mB * J.imp[0];
      vy = vy + J.mB * J.imp[1];
    }
    for (int j = 0; j < I.jn; ++j) {
      if (I.j_ch[j] != i) continue;
      const JointC& J = W.jc[j];
      w = w + J.iB * (cross_vv(J.rbx, J.rby, J.imp[0], J.imp[1])
                      + (J.mot + J.lim));
    }
    W.vx(i) = vx;
    W.vy(i) = vy;
    W.w(i) = w;
  }
  g.sync();
}

// One Gauss-Seidel velocity sweep (_vel_sweep): joints (motor, then the
// coupled limit + point solve) on lane 0, walls on every body's lane, body
// pairs on lane 0. Returns the sweep's largest |impulse delta| over the
// group (for the convergence exit).
template <unsigned G>
PHYS_FN float velocity_sweep(const Group<G>& g, const SpecF& F,
                             const SpecI& I, const World<G>& W,
                             WallC (&wc)[MW]) {
  const int i = g.thread_rank();
  float dm = 0.0f;
  if (i == 0) {
    for (int j = 0; j < I.jn; ++j) {
      JointC& J = W.jc[j];
      const int pa = I.j_pa[j], ch = I.j_ch[j];
      if (!I.j_equal[j]) {
        const float cdot = (W.w(ch) - W.w(pa)) - J.ms;
        const float imp = (-J.axmass) * cdot;
        const float cap = F.j_cap[j];
        const float nw = clampf(J.mot + imp, -cap, cap);
        const float d = nw - J.mot;
        J.mot = J.mot + d;
        W.w(pa) = W.w(pa) - J.iA * d;
        W.w(ch) = W.w(ch) + J.iB * d;
        dm = fmaxf(dm, fabsf(d));
      }
      const float wa = W.w(pa), wb = W.w(ch);
      const float cd1x = ((W.vx(ch) + (-wb) * J.rby) - W.vx(pa)) - (-wa) * J.ray;
      const float cd1y = ((W.vy(ch) + wb * J.rbx) - W.vy(pa)) - wa * J.rax;
      const float cd2 = wb - wa;
      const float k11 = ((J.mA + J.mB) + J.iA * (J.ray * J.ray)) + J.iB * (J.rby * J.rby);
      const float k12 = ((-J.iA) * J.rax) * J.ray - (J.iB * J.rbx) * J.rby;
      const float k13 = (-J.iA) * J.ray - J.iB * J.rby;
      const float k22 = ((J.mA + J.mB) + J.iA * (J.rax * J.rax)) + J.iB * (J.rbx * J.rbx);
      const float k23 = J.iA * J.rax + J.iB * J.rbx;
      const float k33 = J.iA + J.iB;
      float dx, dy, dz;
      joint_block(J.state, cd1x, cd1y, cd2, J.lim, k11, k12, k13, k22, k23,
                  k33, dx, dy, dz);
      J.imp[0] = J.imp[0] + dx;
      J.imp[1] = J.imp[1] + dy;
      J.lim = J.lim + dz;
      W.vx(pa) = W.vx(pa) - J.mA * dx;
      W.vy(pa) = W.vy(pa) - J.mA * dy;
      W.vx(ch) = W.vx(ch) + J.mB * dx;
      W.vy(ch) = W.vy(ch) + J.mB * dy;
      W.w(pa) = W.w(pa) - J.iA * (cross_vv(J.rax, J.ray, dx, dy) + dz);
      W.w(ch) = W.w(ch) + J.iB * (cross_vv(J.rbx, J.rby, dx, dy) + dz);
      dm = fmaxf(dm, fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz)));
    }
  }
  g.sync();
  // walls: per body, sequential over walls; a contact with no velocity
  // point is a no-op (zero masses and impulses) and is skipped
  if (i < I.n) {
    const float im = W.im(i), ii = W.ii(i);
    const float mu = F.w_mu[i];
    float vx = W.vx(i), vy = W.vy(i), w = W.w(i);
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= I.nw) break;
      WallC& C = wc[wi];
      if (!(C.vtouch[0] || C.vtouch[1])) continue;
      const float nx = F.wall_n[wi][0], ny = F.wall_n[wi][1];
      const float tx = ny, ty = -nx;
#pragma unroll
      for (int k = 0; k < 2; ++k) {    // friction, both points
        const float dvx = vx + (-w) * C.rby[k];
        const float dvy = vy + w * C.rbx[k];
        const float vt = dvx * tx + dvy * ty;
        const float lam = (-C.tmass[k]) * vt;
        const float maxf = mu * C.imp[k][0];
        const float old = C.imp[k][1];
        const float nw = clampf(old + lam, -maxf, maxf);
        const float d = nw - old;
        C.imp[k][1] = nw;
        const float Px = d * tx, Py = d * ty;
        vx = vx + im * Px;
        vy = vy + im * Py;
        w = w + ii * cross_vv(C.rbx[k], C.rby[k], Px, Py);
        dm = fmaxf(dm, fabsf(d));
      }
      // normal: sequential candidates, then the 2x2 block candidate
      const float a1 = C.imp[0][0], a2 = C.imp[1][0];
      float vsx = vx, vsy = vy, ws = w;
      float dseq[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float dvx = vsx + (-ws) * C.rby[k];
        const float dvy = vsy + ws * C.rbx[k];
        const float vn = dvx * nx + dvy * ny;
        const float lam = (-C.nmass[k]) * (vn - C.bias[k]);
        const float acc = k ? a2 : a1;
        dseq[k] = fmaxf(acc + lam, 0.0f) - acc;
        if (k == 0) {
          const float Px = dseq[0] * nx, Py = dseq[0] * ny;
          vsx = vsx + im * Px;
          vsy = vsy + im * Py;
          ws = ws + ii * cross_vv(C.rbx[0], C.rby[0], Px, Py);
        }
      }
      float d1 = dseq[0], d2 = dseq[1];
      if (C.block) {
        const float vn1 = (vx + (-w) * C.rby[0]) * nx + (vy + w * C.rbx[0]) * ny;
        const float vn2 = (vx + (-w) * C.rby[1]) * nx + (vy + w * C.rbx[1]) * ny;
        block_lcp(vn1 - C.bias[0], vn2 - C.bias[1], a1, a2, C.kn[0], C.kn[1],
                  C.k12, C.nmass[0], C.nmass[1], d1, d2);
      }
      const float s = d1 + d2;
      vx = vx + im * (s * nx);
      vy = vy + im * (s * ny);
      w = w + ii * (cross_vv(C.rbx[0], C.rby[0], d1 * nx, d1 * ny)
                    + cross_vv(C.rbx[1], C.rby[1], d2 * nx, d2 * ny));
      C.imp[0][0] = a1 + d1;
      C.imp[1][0] = a2 + d2;
      dm = fmaxf(dm, fmaxf(fabsf(d1), fabsf(d2)));
    }
    W.vx(i) = vx;
    W.vy(i) = vy;
    W.w(i) = w;
  }
  g.sync();
  // body pairs
  if (i == 0) {
    for (int p = 0; p < I.np; ++p) {
      PairC& C = W.pc[p];
      if (!I.pair_valid[p] || !(C.vtouch[0] || C.vtouch[1])) continue;
      const int a = I.pair_a[p], b = I.pair_b[p];
      const float nx = C.nx, ny = C.ny, tx = ny, ty = -nx;
      const float mu = F.p_mu[p];
      float vax = W.vx(a), vay = W.vy(a), wa = W.w(a);
      float vbx = W.vx(b), vby = W.vy(b), wb = W.w(b);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float dvx = ((vbx + (-wb) * C.rby[k]) - vax) - (-wa) * C.ray[k];
        const float dvy = ((vby + wb * C.rbx[k]) - vay) - wa * C.rax[k];
        const float vt = dot2(dvx, dvy, tx, ty);
        const float lam = (-C.tmass[k]) * vt;
        const float maxf = mu * C.imp[k][0];
        const float old = C.imp[k][1];
        const float nw = clampf(old + lam, -maxf, maxf);
        const float d = nw - old;
        C.imp[k][1] = nw;
        const float Px = d * tx, Py = d * ty;
        vax = vax - C.imA * Px;
        vay = vay - C.imA * Py;
        vbx = vbx + C.imB * Px;
        vby = vby + C.imB * Py;
        wa = wa - C.iiA * cross_vv(C.rax[k], C.ray[k], Px, Py);
        wb = wb + C.iiB * cross_vv(C.rbx[k], C.rby[k], Px, Py);
        dm = fmaxf(dm, fabsf(d));
      }
      const float a1 = C.imp[0][0], a2 = C.imp[1][0];
      float vsax = vax, vsay = vay, vsbx = vbx, vsby = vby;
      float wsa = wa, wsb = wb;
      float dseq[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float dvx = ((vsbx + (-wsb) * C.rby[k]) - vsax) - (-wsa) * C.ray[k];
        const float dvy = ((vsby + wsb * C.rbx[k]) - vsay) - wsa * C.rax[k];
        const float vn = dot2(dvx, dvy, nx, ny);
        const float lam = (-C.nmass[k]) * (vn - C.bias[k]);
        const float acc = k ? a2 : a1;
        dseq[k] = fmaxf(acc + lam, 0.0f) - acc;
        if (k == 0) {
          const float Px = dseq[0] * nx, Py = dseq[0] * ny;
          vsax = vsax - C.imA * Px;
          vsay = vsay - C.imA * Py;
          vsbx = vsbx + C.imB * Px;
          vsby = vsby + C.imB * Py;
          wsa = wsa - C.iiA * cross_vv(C.rax[0], C.ray[0], Px, Py);
          wsb = wsb + C.iiB * cross_vv(C.rbx[0], C.rby[0], Px, Py);
        }
      }
      float d1 = dseq[0], d2 = dseq[1];
      if (C.block) {
        float vn[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float dvx = ((vbx + (-wb) * C.rby[k]) - vax) - (-wa) * C.ray[k];
          const float dvy = ((vby + wb * C.rbx[k]) - vay) - wa * C.rax[k];
          vn[k] = dot2(dvx, dvy, nx, ny);
        }
        block_lcp(vn[0] - C.bias[0], vn[1] - C.bias[1], a1, a2, C.kn[0],
                  C.kn[1], C.k12, C.nmass[0], C.nmass[1], d1, d2);
      }
      const float s = d1 + d2;
      const float Px = s * nx, Py = s * ny;
      vax = vax - C.imA * Px;
      vay = vay - C.imA * Py;
      vbx = vbx + C.imB * Px;
      vby = vby + C.imB * Py;
      const float n1x = d1 * nx, n1y = d1 * ny, n2x = d2 * nx, n2y = d2 * ny;
      const float dw = cross_vv(C.rax[0], C.ray[0], n1x, n1y)
          + cross_vv(C.rax[1], C.ray[1], n2x, n2y);
      const float dwb = cross_vv(C.rbx[0], C.rby[0], n1x, n1y)
          + cross_vv(C.rbx[1], C.rby[1], n2x, n2y);
      wa = wa - C.iiA * dw;
      wb = wb + C.iiB * dwb;
      W.vx(a) = vax; W.vy(a) = vay; W.w(a) = wa;
      W.vx(b) = vbx; W.vy(b) = vby; W.w(b) = wb;
      C.imp[0][0] = a1 + d1;
      C.imp[1][0] = a2 + d2;
      dm = fmaxf(dm, fmaxf(fabsf(d1), fabsf(d2)));
    }
  }
  g.sync();
  return group_max(g, dm);
}

// velocity_solve: vel_iters sweeps; with exit_tol > 0 the world stops after
// the first sweep whose largest impulse delta is <= exit_tol (the group's
// max, so every lane of the world leaves together).
template <unsigned G>
PHYS_FN void velocity_solve(const Group<G>& g, const SpecF& F, const SpecI& I,
                            const World<G>& W, WallC (&wc)[MW]) {
  for (int it = 0; it < I.vel_iters; ++it) {
    const float dm = velocity_sweep(g, F, I, W, wc);
    if (F.exit_tol > 0.0f && dm <= F.exit_tol) break;
  }
}

// Steps 7-8 (_position_solve): integrate positions from the state's poses
// into W.cx/cy/a, then NGS corrections (walls on every body's lane; pairs,
// then joints, limit then point, on lane 0). The loop stops after the first
// iteration that meets b2Island::Solve's exit (contact separation >= -3 *
// linearSlop and every joint within its slops; a min and an any over the
// group); that iteration's corrections are kept. Returns the iterations
// run, the same on every lane (mega_rollout.cu's counted instance adds them
// up; elsewhere the count is dead code).
template <unsigned G>
PHYS_FN int position_solve(const Group<G>& g, const SpecF& F, const SpecI& I,
                           const World<G>& W, const WallC (&wc)[MW]) {
  const int i = g.thread_rank();
  const float dt = F.dt;
  if (i < I.n) {
    W.cx(i) = W.sx(i) + dt * W.vx(i);
    W.cy(i) = W.sy(i) + dt * W.vy(i);
    W.a(i) = W.sa(i) + dt * W.w(i);
  }
  int ran = 0;
  for (int it = 0; it < I.pos_iters; ++it) {
    ++ran;
    float minsep = 0.0f;
    if (i < I.n) {
      float cx = W.cx(i), cy = W.cy(i), ca = W.a(i);
      const float im = W.im(i), ii = W.ii(i);
#pragma unroll
      for (int wi = 0; wi < MW; ++wi) {
        if (wi >= I.nw) break;
        const WallC& C = wc[wi];
        const float nx = F.wall_n[wi][0], ny = F.wall_n[wi][1];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!C.touch[k]) continue;     // a zero impulse: no change
          float rx, ry;
          rot(cosf(ca), sinf(ca), C.lpx[k], C.lpy[k], rx, ry);
          const float ptx = cx + rx, pty = cy + ry;
          const float sep = ((ptx * nx + pty * ny) - F.wall_off[wi]) - C.rad_sub;
          minsep = fminf(minsep, sep);
          const float Cc = clampf(BAUMGARTE * (sep + LINEAR_SLOP),
                                  -MAX_LINEAR_CORRECTION, 0.0f);
          const float rbx = ptx - cx, rby = pty - cy;
          const float rn = rbx * ny - rby * nx;
          const float kn = im + ii * (rn * rn);
          const float imp = (-Cc) / fmaxf(kn, 1e-12f);
          const float Px = imp * nx, Py = imp * ny;
          cx = cx + im * Px;
          cy = cy + im * Py;
          ca = ca + ii * cross_vv(rbx, rby, Px, Py);
        }
      }
      W.cx(i) = cx;
      W.cy(i) = cy;
      W.a(i) = ca;
    }
    g.sync();
    bool jbad = false;
    if (i == 0) {
      for (int p = 0; p < I.np; ++p) {
        const PairC& C = W.pc[p];
        const int ia = I.pair_a[p], ib = I.pair_b[p];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!C.touch[k]) continue;
          const float csA = cosf(W.a(ia)), snA = sinf(W.a(ia));
          const float csB = cosf(W.a(ib)), snB = sinf(W.a(ib));
          float nx, ny, ptx, pty, sep, rx, ry;
          if (C.mtype == 0) {
            rot(csB, snB, C.lpsx[0], C.lpsy[0], rx, ry);
            const float pax = W.cx(ia), pay = W.cy(ia);
            const float pbx = W.cx(ib) + rx, pby = W.cy(ib) + ry;
            const float dx = pbx - pax, dy = pby - pay;
            const float dist = sqrtf(dx * dx + dy * dy);
            const float dd = fmaxf(dist, 1e-9f);
            nx = dist > 1e-9f ? dx / dd : 0.0f;
            ny = dist > 1e-9f ? dy / dd : 1.0f;
            sep = dist - C.rad_sub;
            ptx = 0.5f * (pax + pbx);
            pty = 0.5f * (pay + pby);
          } else {
            // face on A (mtype 1) or on B (mtype 2); the clip point is on
            // the other body
            const bool fa = C.mtype == 1;
            const float cf = fa ? csA : csB, sf = fa ? snA : snB;
            const float co = fa ? csB : csA, so = fa ? snB : snA;
            const int bf = fa ? ia : ib, bo = fa ? ib : ia;
            float fnx, fny, plx, ply;
            rot(cf, sf, C.lnx, C.lny, fnx, fny);
            rot(cf, sf, C.lppx, C.lppy, plx, ply);
            plx = W.cx(bf) + plx;
            ply = W.cy(bf) + ply;
            rot(co, so, C.lpsx[k], C.lpsy[k], rx, ry);
            ptx = W.cx(bo) + rx;
            pty = W.cy(bo) + ry;
            sep = dot2(ptx - plx, pty - ply, fnx, fny) - C.rad_sub;
            nx = fa ? fnx : -fnx;
            ny = fa ? fny : -fny;
          }
          minsep = fminf(minsep, sep);
          const float Cc = clampf(BAUMGARTE * (sep + LINEAR_SLOP),
                                  -MAX_LINEAR_CORRECTION, 0.0f);
          const float rax = ptx - W.cx(ia), ray = pty - W.cy(ia);
          const float rbx = ptx - W.cx(ib), rby = pty - W.cy(ib);
          const float rnA = cross_vv(rax, ray, nx, ny);
          const float rnB = cross_vv(rbx, rby, nx, ny);
          const float kn = ((W.im(ia) + W.im(ib)) + W.ii(ia) * (rnA * rnA))
              + W.ii(ib) * (rnB * rnB);
          const float imp = (-Cc) / fmaxf(kn, 1e-12f);
          const float Px = imp * nx, Py = imp * ny;
          W.cx(ia) = W.cx(ia) - W.im(ia) * Px;
          W.cy(ia) = W.cy(ia) - W.im(ia) * Py;
          W.cx(ib) = W.cx(ib) + W.im(ib) * Px;
          W.cy(ib) = W.cy(ib) + W.im(ib) * Py;
          W.a(ia) = W.a(ia) - W.ii(ia) * cross_vv(rax, ray, Px, Py);
          W.a(ib) = W.a(ib) + W.ii(ib) * cross_vv(rbx, rby, Px, Py);
        }
      }
      for (int j = 0; j < I.jn; ++j) {
        const JointC& J = W.jc[j];
        const int pa = I.j_pa[j], ch = I.j_ch[j];
        const float ang = (W.a(ch) - W.a(pa)) - J.ref;
        const float lo = F.j_lower[j], hi = F.j_upper[j];
        const float c_eq = clampf(ang - lo, -MAX_ANGULAR_CORRECTION,
                                  MAX_ANGULAR_CORRECTION);
        const float c_lo = clampf((ang - lo) + ANGULAR_SLOP,
                                  -MAX_ANGULAR_CORRECTION, 0.0f);
        const float c_hi = clampf((ang - hi) - ANGULAR_SLOP, 0.0f,
                                  MAX_ANGULAR_CORRECTION);
        float Cc = 0.0f, ang_err = 0.0f;
        if (J.state == 3) { Cc = c_eq; ang_err = fabsf(c_eq); }
        else if (J.state == 1) { Cc = c_lo; ang_err = lo - ang; }
        else if (J.state == 2) { Cc = c_hi; ang_err = ang - hi; }
        const float d = (-J.axmass) * Cc;
        const float apa = W.a(pa) - J.iA * d;
        const float ach = W.a(ch) + J.iB * d;
        float rax, ray, rbx, rby;
        rot(cosf(apa), sinf(apa), F.j_anchor_a[j][0] - W.lcx(pa),
            F.j_anchor_a[j][1] - W.lcy(pa), rax, ray);
        rot(cosf(ach), sinf(ach), F.j_anchor_b[j][0] - W.lcx(ch),
            F.j_anchor_b[j][1] - W.lcy(ch), rbx, rby);
        const float cvx = ((W.cx(ch) + rbx) - W.cx(pa)) - rax;
        const float cvy = ((W.cy(ch) + rby) - W.cy(pa)) - ray;
        const float pos_err = sqrtf(cvx * cvx + cvy * cvy);
        const float k11 = ((J.mA + J.mB) + J.iA * (ray * ray)) + J.iB * (rby * rby);
        const float k12 = ((-J.iA) * rax) * ray - (J.iB * rbx) * rby;
        const float k22 = ((J.mA + J.mB) + J.iA * (rax * rax)) + J.iB * (rbx * rbx);
        float det = k11 * k22 - k12 * k12;
        det = fabsf(det) > 1e-12f ? det : 1.0f;
        const float Px = (-(k22 * cvx - k12 * cvy)) / det;
        const float Py = (-(k11 * cvy - k12 * cvx)) / det;
        W.cx(pa) = W.cx(pa) - J.mA * Px;
        W.cy(pa) = W.cy(pa) - J.mA * Py;
        W.cx(ch) = W.cx(ch) + J.mB * Px;
        W.cy(ch) = W.cy(ch) + J.mB * Py;
        W.a(pa) = apa - J.iA * cross_vv(rax, ray, Px, Py);
        W.a(ch) = ach + J.iB * cross_vv(rbx, rby, Px, Py);
        jbad = jbad || pos_err > LINEAR_SLOP || ang_err > ANGULAR_SLOP;
      }
    }
    g.sync();
    minsep = group_min(g, minsep);
    if (minsep >= MIN_SEP_OK && !g.any(jbad)) break;
  }
  return ran;
}

// Steps 9-10 (_finalize): island sleeping (min-label propagation over joints
// and touching pairs, label_rounds Jacobi rounds, each lane relabelling its
// own body) and the state writeback: each lane its body and walls, pairs by
// pair index (joint carries are already in place).
template <unsigned G>
PHYS_FN void finalize(const Group<G>& g, const SpecF& F, const SpecI& I,
                      const World<G>& W, Own& o, WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n;
  if (I.allow_sleep) {
    if (i < n) W.label(i) = i;
    g.sync();
    for (int r = 0; r < I.label_rounds; ++r) {
      int nxt = 0;
      if (i < n) {
        nxt = W.label(i);
        for (int j = 0; j < I.jn; ++j) {
          const int pa = I.j_pa[j], ch = I.j_ch[j];
          if (pa == i) { const int l = W.label(ch); nxt = l < nxt ? l : nxt; }
          if (ch == i) { const int l = W.label(pa); nxt = l < nxt ? l : nxt; }
        }
        for (int p = 0; p < I.np; ++p) {
          const PairC& C = W.pc[p];
          if (!(C.touch[0] || C.touch[1])) continue;
          const int a = I.pair_a[p], b = I.pair_b[p];
          if (a == i) { const int l = W.label(b); nxt = l < nxt ? l : nxt; }
          if (b == i) { const int l = W.label(a); nxt = l < nxt ? l : nxt; }
        }
      }
      g.sync();
      if (i < n) W.label(i) = nxt;
      g.sync();
    }
    if (i < n) {
      bool forced = false;
      for (int j = 0; j < I.jn; ++j)
        if (W.jc[j].mchg && (I.j_pa[j] == i || I.j_ch[j] == i)) forced = true;
      const float vx = W.vx(i), vy = W.vy(i), w = W.w(i);
      const bool slow = (vx * vx + vy * vy) <= LIN_SLEEP_TOL_SQ
          && w * w <= ANG_SLEEP_TOL_SQ;
      W.sleep(i) = slow && !forced ? W.sleep(i) + F.dt : 0.0f;
    }
    g.sync();
    if (i < n) {
      float isl = INFINITY;
      const int li = W.label(i);
      for (int k = 0; k < n; ++k)
        if (W.label(k) == li) isl = fminf(isl, W.sleep(k));
      if (isl >= TIME_TO_SLEEP) {   // asleep: velocities 0, poses kept
        W.vx(i) = W.vy(i) = W.w(i) = 0.0f;
        W.cx(i) = W.sx(i);
        W.cy(i) = W.sy(i);
        W.a(i) = W.sa(i);
      }
    }
  }
  if (i < n) {
    W.sx(i) = W.cx(i); W.sy(i) = W.cy(i); W.sa(i) = W.a(i);
    o.vx = W.vx(i); o.vy = W.vy(i); o.w = W.w(i);
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= I.nw) break;
      WallC& C = wc[wi];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        C.imp[k][0] = C.touch[k] ? C.imp[k][0] : 0.0f;
        C.imp[k][1] = C.touch[k] ? C.imp[k][1] : 0.0f;
        C.ids[k] = C.touch[k] ? C.ids[k] : -1;
      }
    }
  }
  for (int p = i; p < I.np; p += G) {
    PairC& C = W.pc[p];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      C.imp[k][0] = C.touch[k] ? C.imp[k][0] : 0.0f;
      C.imp[k][1] = C.touch[k] ? C.imp[k][1] : 0.0f;
      C.ids[k] = C.touch[k] ? C.ids[k] : -1;
    }
  }
  g.sync();
}

// One env step (step_world_motor): substeps x the whole pipeline at the
// motor speeds in the joint records' ms. W.im/ii/lcx/lcy must hold
// body_constants. Returns the NGS iterations of its substeps.
template <unsigned G>
PHYS_FN int step(const Group<G>& g, const SpecF& F, const SpecI& I,
                 const World<G>& W, Own& o, WallC (&wc)[MW]) {
  const int i = g.thread_rank();
  for (int j = i; j < I.nj; j += G) {
    JointC& J = W.jc[j];
    J.mchg = J.ms != J.prev_motor && I.j_valid[j];
  }
  g.sync();
  int ngs = 0;
  for (int s = 0; s < I.substeps; ++s) {
    presolve(g, F, I, W, o, wc);
    warm_start(g, F, I, W, wc);
    velocity_solve(g, F, I, W, wc);
    ngs += position_solve(g, F, I, W, wc);
    finalize(g, F, I, W, o, wc);
  }
  for (int j = i; j < I.nj; j += G) W.jc[j].prev_motor = W.jc[j].ms;
  g.sync();
  return ngs;
}

}  // namespace phys

// The shared layout constants, which engine/mega.py mirrors and checks in
// each library that includes this header: body arrays, words of a pair
// record and of a joint record.
extern "C" void phys_layout(int* body_arrays, int* pair_words,
                            int* joint_words) {
  *body_arrays = phys::BODY_ARRAYS;
  *pair_words = phys::PAIR_WORDS;
  *joint_words = phys::JOINT_WORDS;
}
