// Pillow-exact raster device functions shared by the LCD kernels
// (lcd_raster.cu: one frame per world; traj_raster.cu: a whole rollout).
//
// Each function reproduces one step of render/raster.py's plain torch path
// bit for bit, which itself reproduces Pillow: the b2Mul vertex transform in
// float32 op order with every product rounded, truncation to integer pixels,
// Pillow's polygon_generic scanline fill (edge intersections in float32,
// endpoint doubling, the corner-connection fix-up, sort + pair fill with
// floor(x+0.5) / round-half-toward-zero span ends, hlines for horizontal
// edges), the tabulated PIL ellipse rows for circles, and the per-world
// RANDOM-shape select. Sources that include this header build with
// --fmad=false and IEEE division (nvcc's default -prec-div=true): an FMA in
// the vertex transform or in the edge intersection flips pixels at span
// edges.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LCD_MAXV 8                   // engine/geom.py MAX_VERTS
#define LCD_MAXS (2 * LCD_MAXV + 2)  // edge-crossing slots per row
#define LCD_CIRCLE 0                 // engine/spec.py shape flags
#define LCD_POLY 1

namespace lcd {

__device__ __forceinline__ float round_half_away(float x) {  // C roundf
  float a = fabsf(x);
  float fl = floorf(a);
  float r = __fadd_rn(fl, (__fsub_rn(a, fl) >= 0.5f) ? 1.0f : 0.0f);
  return x < 0.0f ? -r : r;
}

__device__ __forceinline__ float x_start(float f) {
  return f >= 0.0f ? floorf(__fadd_rn(f, 0.5f)) : -floorf(__fadd_rn(-f, 0.5f));
}

__device__ __forceinline__ float x_end(float f) {
  return f >= 0.0f ? ceilf(__fsub_rn(f, 0.5f)) : -ceilf(__fsub_rn(-f, 0.5f));
}

// bits [0, k) for k in [0, W]; the shift is clamped to 31 (a 32-bit shift is
// undefined)
__device__ __forceinline__ uint32_t bits_below(int k, int W, uint32_t full) {
  return k >= W ? full : ((1u << min(k, 31)) - 1u);
}

__device__ __forceinline__ uint32_t span_bits(float af, float bf, bool valid,
                                              int W, uint32_t full) {
  int a = (int)fminf(fmaxf(af, 0.0f), (float)W);
  int b = (int)fminf(fmaxf(bf, -1.0f), (float)(W - 1)) + 1;   // half-open
  if (!valid || a >= b) return 0u;
  return bits_below(b, W, full) & ~bits_below(a, W, full);
}

__device__ __forceinline__ uint32_t full_bits(int W) {
  return W >= 32 ? 0xFFFFFFFFu : ((1u << W) - 1u);
}

// Pillow polygon_generic for PIL row y of one integer-vertex polygon.
__device__ uint32_t poly_row(const int* ivx, const int* ivy, int nv, int y,
                             int H, int W, uint32_t full) {
  float ex0[LCD_MAXV], edx[LCD_MAXV];
  int eymin[LCD_MAXV], eymax[LCD_MAXV];
  bool ehoriz[LCD_MAXV];
  int vymax = ivy[0];
  for (int i = 1; i < nv; ++i) vymax = max(vymax, ivy[i]);
  const int gymax = min(vymax, H);
  for (int i = 0; i < nv; ++i) {
    const int i1 = (i + 1) % nv;
    const int x0 = ivx[i], y0 = ivy[i], x1 = ivx[i1], y1 = ivy[i1];
    ehoriz[i] = y0 == y1;
    edx[i] = ehoriz[i] ? 0.0f : __fdiv_rn((float)(x1 - x0), (float)(y1 - y0));
    ex0[i] = (float)(y0 <= y1 ? x0 : x1);
    eymin[i] = min(y0, y1);
    eymax[i] = max(y0, y1);
  }
  // edge x at row yy: the product rounds before the add
#define EDGE_X(k, yy) __fadd_rn(__fmul_rn((float)((yy) - eymin[k]), edx[k]), ex0[k])
  const int S = 2 * nv + 2;
  float xx[LCD_MAXS];
  for (int s = 0; s < S; ++s) xx[s] = __int_as_float(0x7f800000);   // +inf
  int j = 0;
  for (int i = 0; i < nv; ++i) {
    const bool inr = !ehoriz[i] && y >= eymin[i] && y <= eymax[i];
    const float cur_x = EDGE_X(i, y);
    if (inr) xx[j] = cur_x;
    const bool at_ymax = inr && y == eymax[i];
    const bool at_ymin = inr && y == eymin[i];
    const bool dbl = at_ymax && y < gymax;
    const int j1 = j + (inr ? 1 : 0);
    if (dbl) xx[j1] = cur_x;
    // corner-connection fix-up (Draw.c: only at an endpoint row; at ymax only
    // on the clipped bottom row, where the doubling branch doesn't run)
    if (i > 0) {
      const bool elig = edx[i] != 0.0f && (at_ymin || (at_ymax && y >= gymax));
      const int adj_y = y + (at_ymax ? -1 : 1);
      const float adj = EDGE_X(i, adj_y);
      const float cur_r = round_half_away(cur_x);
      bool found = false;
      float adj_o = 0.0f;
      for (int k = 0; k < i; ++k) {
        const bool ok = !ehoriz[k] && (y == eymin[k] || y == eymax[k])
            && cur_r == round_half_away(EDGE_X(k, y))
            && adj_y >= eymin[k] && adj_y <= eymax[k];
        if (ok && !found) adj_o = EDGE_X(k, adj_y);
        found = found || ok;
      }
      const bool hi = cur_x > __fadd_rn(adj, 1.0f) && cur_x > __fadd_rn(adj_o, 1.0f);
      const bool lo = cur_x < __fsub_rn(adj, 1.0f) && cur_x < __fsub_rn(adj_o, 1.0f);
      const float fixv = hi ? __fadd_rn(round_half_away(fmaxf(adj, adj_o)), 1.0f)
                            : __fsub_rn(round_half_away(fminf(adj, adj_o)), 1.0f);
      if (elig && found && (hi || lo)) xx[j] = fixv;
    }
    j = j1 + (dbl ? 1 : 0);
  }
#undef EDGE_X
  // insertion sort of the j crossings (the rest stay +inf)
  for (int s = 1; s < j; ++s) {
    const float key = xx[s];
    int t = s - 1;
    while (t >= 0 && xx[t] > key) { xx[t + 1] = xx[t]; --t; }
    xx[t + 1] = key;
  }
  uint32_t mask = 0u;
  for (int p = 0; 2 * p + 1 < S; ++p)
    mask |= span_bits(x_start(xx[2 * p]), x_end(xx[2 * p + 1]), j >= 2 * p + 2,
                      W, full);
  // horizontal edges are hlined directly (ImagingDrawPolygon first loop)
  for (int i = 0; i < nv; ++i) {
    const int i1 = (i + 1) % nv;
    if (ehoriz[i] && y == ivy[i])
      mask |= span_bits((float)min(ivx[i], ivx[i1]), (float)max(ivx[i], ivx[i1]),
                        true, W, full);
  }
  return mask;
}

// One row of the tabulated PIL ellipse mask, shifted into image columns.
__device__ uint32_t circle_row(float cx, float cy, float r, float s, int y,
                               const uint32_t* tbl, int dmax, uint32_t full) {
  const int ix0 = (int)truncf(__fmul_rn(__fsub_rn(cx, r), s));
  const int iy0 = (int)truncf(__fmul_rn(__fsub_rn(cy, r), s));
  const int iw = min(max((int)truncf(__fmul_rn(__fadd_rn(cx, r), s)) - ix0, 0), dmax);
  const int ih = min(max((int)truncf(__fmul_rn(__fadd_rn(cy, r), s)) - iy0, 0), dmax);
  const int di = y - iy0;
  if (di < 0 || di > ih) return 0u;
  const uint32_t bits = tbl[((long)ih * (dmax + 1) + iw) * (dmax + 2) + min(di, dmax + 1)];
  uint32_t shifted;
  if (ix0 >= 0) shifted = ix0 < 32 ? bits << min(ix0, 31) : 0u;
  else shifted = -ix0 < 32 ? bits >> min(-ix0, 31) : 0u;
  return shifted & full;
}

// The per-spec constants every LCD kernel reads.
struct BodyTables {
  const int* shape_static;    // (N,) CIRCLE | POLY | RANDOM
  const int* nverts;          // (N,)
  const float* radius;        // (N,)
  const float* draw_verts;    // (N, V, 2)
  const float* lc;            // (N, 2) polygon-variant local center
  const uint32_t* tbl;        // (dmax+1, dmax+1, dmax+2) ellipse rows
  int V, dmax;
  float s;                    // world-to-pixel scale
};

// PIL row y of body b's fill, for a body whose pose is (cx, cy, ca, sa):
// the circle row, or the polygon's b2Mul-transformed, truncated scanline
// row, chosen by the body's static shape or, for RANDOM bodies, by circ.
__device__ uint32_t body_row(const BodyTables& K, int b, bool circ_flag,
                             float cx, float cy, float ca, float sa, int y,
                             int H, int W, uint32_t full) {
  const int kind = K.shape_static[b];
  const bool circ = kind == LCD_CIRCLE || (kind != LCD_POLY && circ_flag);
  if (circ) return circle_row(cx, cy, K.radius[b], K.s, y, K.tbl, K.dmax, full);
  // b2Mul op order: w = (cos*vx - sin*vy) + origin, each product rounded
  const float lc0 = K.lc[2 * b], lc1 = K.lc[2 * b + 1];
  const float ox = __fsub_rn(cx, __fsub_rn(__fmul_rn(ca, lc0), __fmul_rn(sa, lc1)));
  const float oy = __fsub_rn(cy, __fadd_rn(__fmul_rn(sa, lc0), __fmul_rn(ca, lc1)));
  const int nv = K.nverts[b];
  int ivx[LCD_MAXV], ivy[LCD_MAXV];
  for (int v = 0; v < nv; ++v) {
    const float dx = K.draw_verts[(b * K.V + v) * 2];
    const float dy = K.draw_verts[(b * K.V + v) * 2 + 1];
    const float wx = __fadd_rn(__fsub_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy)), ox);
    const float wy = __fadd_rn(__fadd_rn(__fmul_rn(sa, dx), __fmul_rn(ca, dy)), oy);
    ivx[v] = (int)truncf(__fmul_rn(wx, K.s));
    ivy[v] = (int)truncf(__fmul_rn(wy, K.s));
  }
  return poly_row(ivx, ivy, nv, y, H, W, full);
}

}  // namespace lcd
