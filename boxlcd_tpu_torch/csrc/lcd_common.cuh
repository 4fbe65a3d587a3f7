// Pillow-exact LCD raster for Hopper (sm_90a): the frame core shared by
// lcd_raster.cu (one frame per world) and traj_raster.cu (every frame of a
// rollout), which differ only in where a frame's poses lie.
//
// Every frame equals render/raster.py's plain torch path (lcd_rows_plain)
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
//
// Layout of a launch (render/cuda_raster.py launch_geometry sizes it and the
// launchers check it): a frame is a tile of G lanes (H rounded up to a power
// of two, at most 32, at least NV), so a warp holds 32 / G frames, synced
// with the tile's masked __syncwarp. A frame runs in two passes over its
// slice of dynamic shared memory:
//   1. setup, once per (frame, body): a body is a group of NV lanes, G / NV
//      bodies a pass; lane i of the group transforms vertex i and writes
//      edge i (one IEEE division), taking the edge's far vertex from the
//      next lane and the body's rows from a shuffle min/max. The group
//      picks circle or polygon (RANDOM bodies by is_circle) and writes the
//      body's slot: the polygon's edge table or the circle's integer bbox,
//      and for both the body's PIL row range [ylo, ylo + rows);
//   2. rows: the frame's (body, row) pairs inside those ranges, and only
//      those, are dealt out over the tile's lanes in body order, every lane
//      running the same passes, so the lanes of a warp run the same row
//      code at once on different bodies; each ORs its row's bits into the
//      frame's row words with a shared atomicOr. Outside its range a body's
//      row is 0 (every polygon term needs an edge that spans the row or a
//      vertex on it; the ellipse table is 0 off its bbox rows), so skipping
//      it is exact.
// Lane r then writes image row r (PIL row H - 1 - r, inverted): a tile
// stores its frame's H words contiguously.
//
// Nothing lives in local memory: the polygon row keeps its edge table, its
// 2 * NV crossing slots and its sort in registers, unrolled on NV, the
// compile-time vertex bound (4 or 8; the launch picks it from the spec's
// largest vertex count; bodies of at most 4 vertices run the 4-edge code).
// Edge i's crossings go to fixed slots 2i and 2i + 1 in place of Pillow's
// append, and a bitonic compare-exchange network sorts all the slots. That
// gives the sorted crossings Pillow's sort gives: the same values, the
// unused slots hold +inf and stay last, and equal keys differ at most in the
// sign of zero, which x_start and x_end map alike. The spec tables are read
// through the read-only cache (__ldg): only setup and circle rows read them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LCD_CIRCLE 0                 // engine/spec.py shape flags
#define LCD_POLY 1

namespace lcd {

// render/cuda_raster.py mirrors these (THREADS, HEAD_WORDS, EDGE_ARRAYS):
// a block is one warp (blocks of 32-256 threads time within 3% of each
// other on the H100, one warp the fastest for the trajectory raster);
// a body slot is a header {ylo, rows, circle, gymax | ix0} and, for a
// polygon, the edge arrays ex0, edx, eymin, eymax, hlo, hhi of NV words
// each; for a circle, {iy0, table row base}.
constexpr int THREADS = 32;
constexpr int HEAD_WORDS = 4;
constexpr int EDGE_ARRAYS = 6;
// a body's row code, in its header: a polygon of at most 4 vertices, a
// circle, a polygon of 5 to NV vertices
constexpr int ROW_POLY4 = 0, ROW_CIRCLE = 1, ROW_POLY8 = 2;

__host__ __device__ inline int slot_words(int NV) {
  return HEAD_WORDS + EDGE_ARRAYS * NV;
}

// A frame's words: its H row words padded to 4, then N body slots.
__host__ __device__ inline int frame_words(int N, int H, int NV) {
  return ((H + 3) & ~3) + N * slot_words(NV);
}

// Lanes a frame: H rounded up to a power of two, at most a warp and at
// least a body's group of NV lanes.
__host__ __device__ inline int tile_lanes(int H, int NV) {
  int G = NV;
  while (G < H && G < 32) G *= 2;
  return G;
}

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

__host__ __device__ inline uint32_t full_bits(int W) {
  return W >= 32 ? 0xFFFFFFFFu : ((1u << W) - 1u);
}

// The per-spec constants and the frame size.
struct Tables {
  const int* shape_static;    // (N,) CIRCLE | POLY | RANDOM
  const int* nverts;          // (N,)
  const float* radius;        // (N,)
  const float* draw_verts;    // (N, V, 2)
  const float* lc;            // (N, 2) polygon-variant local center
  const uint32_t* tbl;        // (dmax+1, dmax+1, dmax+2) ellipse rows
  int N, V, H, W, dmax;
  float s;                    // world-to-pixel scale
};

// Where one frame's poses lie: body b's x at x[b * xy_stride], y at
// y[b * xy_stride], cos and sin at cs / sn[b * cs_stride], is_circle at
// circ[b]. The launchers' accessors build it from the frame index.
struct PoseView {
  const float* x;
  const float* y;
  const float* cs;
  const float* sn;
  const uint8_t* circ;
  long xy_stride, cs_stride;
};

// NV words from 16-byte aligned shared memory, as floats or as ints.
template <int NV>
__device__ __forceinline__ void load_floats(const int* p, float (&dst)[NV]) {
  static_assert(NV % 4 == 0, "NV is a multiple of 4");
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(p)[q];
    dst[4 * q] = __int_as_float(v.x);
    dst[4 * q + 1] = __int_as_float(v.y);
    dst[4 * q + 2] = __int_as_float(v.z);
    dst[4 * q + 3] = __int_as_float(v.w);
  }
}

template <int NV>
__device__ __forceinline__ void load_ints(const int* p, int (&dst)[NV]) {
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(p)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ int row_count(int ylo, int yhi) {
  return yhi >= ylo ? yhi - ylo + 1 : 0;
}

// Setup of the frame's bodies into their slots (see the layout above). A
// body is a group of NV lanes, lane i of the group taking its vertex i and
// edge i (vertex i + 1 comes from the next lane), G / NV bodies a pass.
// Vertices go through the b2Mul transform in its op order (w = (cos*vx -
// sin*vy) + origin, each product rounded) and truncate to pixels; edges past
// nv are horizontal at row -1, which no row reaches, so they add nothing.
template <int NV>
__device__ __forceinline__ void frame_setup(const Tables& K, const PoseView& p,
                                            int lane, int G, unsigned tile,
                                            int* bodies) {
  const int i = lane % NV, SW = slot_words(NV);
  const float s = K.s;
  for (int b0 = 0; b0 < K.N; b0 += G / NV) {
    const int b = b0 + lane / NV;
    const bool live = b < K.N;
    // every load at once, so a lane waits for memory once
    int kind = LCD_POLY, nv = 0;
    bool flag = false;
    float cx = 0.0f, cy = 0.0f, ca = 0.0f, sa = 0.0f, lc0 = 0.0f, lc1 = 0.0f;
    float dx = 0.0f, dy = 0.0f;
    if (live) {
      kind = __ldg(K.shape_static + b);
      flag = __ldg(p.circ + b) != 0;
      cx = __ldg(p.x + b * p.xy_stride);
      cy = __ldg(p.y + b * p.xy_stride);
      ca = __ldg(p.cs + b * p.cs_stride);
      sa = __ldg(p.sn + b * p.cs_stride);
      nv = __ldg(K.nverts + b);
      lc0 = __ldg(K.lc + 2 * b);
      lc1 = __ldg(K.lc + 2 * b + 1);
      if (i < K.V) {
        dx = __ldg(K.draw_verts + ((long)b * K.V + i) * 2);
        dy = __ldg(K.draw_verts + ((long)b * K.V + i) * 2 + 1);
      }
    }
    const bool circ = kind == LCD_CIRCLE || (kind != LCD_POLY && flag);
    if (circ) nv = 0;
    const bool real = i < nv;
    int ivx = 0, ivy = 0;
    if (real) {
      const float ox = __fsub_rn(cx, __fsub_rn(__fmul_rn(ca, lc0), __fmul_rn(sa, lc1)));
      const float oy = __fsub_rn(cy, __fadd_rn(__fmul_rn(sa, lc0), __fmul_rn(ca, lc1)));
      const float wx = __fadd_rn(__fsub_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy)), ox);
      const float wy = __fadd_rn(__fadd_rn(__fmul_rn(sa, dx), __fmul_rn(ca, dy)), oy);
      ivx = (int)truncf(__fmul_rn(wx, s));
      ivy = (int)truncf(__fmul_rn(wy, s));
    }
    // the edge's far vertex (vertex 0 after the last) and the body's rows
    const int nxt = lane - i + (i + 1 < nv ? i + 1 : 0);
    const int x1 = __shfl_sync(tile, ivx, nxt, G);
    const int y1 = __shfl_sync(tile, ivy, nxt, G);
    int vymin = real ? ivy : 0x7FFFFFFF, vymax = real ? ivy : -0x7FFFFFFF - 1;
#pragma unroll
    for (int o = NV / 2; o > 0; o /= 2) {
      vymin = min(vymin, __shfl_xor_sync(tile, vymin, o, G));
      vymax = max(vymax, __shfl_xor_sync(tile, vymax, o, G));
    }
    if (!live) continue;
    int* slot = bodies + b * SW;
    if (circ) {
      if (i != 0) continue;
      const float r = __ldg(K.radius + b);
      const int dmax = K.dmax, H = K.H;
      const int ix0 = (int)truncf(__fmul_rn(__fsub_rn(cx, r), s));
      const int iy0 = (int)truncf(__fmul_rn(__fsub_rn(cy, r), s));
      const int iw = min(max((int)truncf(__fmul_rn(__fadd_rn(cx, r), s)) - ix0, 0), dmax);
      const int ih = min(max((int)truncf(__fmul_rn(__fadd_rn(cy, r), s)) - iy0, 0), dmax);
      const int ylo = max(iy0, 0), yhi = ih + min(iy0, H - 1 - ih);
      reinterpret_cast<int4*>(slot)[0] =
          make_int4(ylo, row_count(ylo, yhi), ROW_CIRCLE, ix0);
      slot[HEAD_WORDS] = iy0;
      slot[HEAD_WORDS + 1] = (ih * (dmax + 1) + iw) * (dmax + 2);
      continue;
    }
    if (i == 0) {
      const int ylo = max(vymin, 0), yhi = min(vymax, K.H - 1);
      reinterpret_cast<int4*>(slot)[0] = make_int4(
          ylo, row_count(ylo, yhi), NV > 4 && nv > 4 ? ROW_POLY8 : ROW_POLY4,
          min(vymax, K.H));                                            // gymax
    }
    const bool horiz = ivy == y1;
    float edx = 0.0f;
    if (real && !horiz) edx = __fdiv_rn((float)(x1 - ivx), (float)(y1 - ivy));
    int* e = slot + HEAD_WORDS + i;
    e[0] = __float_as_int(real ? (float)(ivy <= y1 ? ivx : x1) : 0.0f);   // ex0
    e[NV] = __float_as_int(edx);                                          // edx
    e[2 * NV] = real ? min(ivy, y1) : -1;                                 // eymin
    e[3 * NV] = real ? max(ivy, y1) : -1;                                 // eymax
    e[4 * NV] = real ? min(ivx, x1) : 0;                                  // hlo
    e[5 * NV] = real ? max(ivx, x1) : 0;                                  // hhi
  }
}

// Pillow polygon_generic for PIL row y of one polygon, from the first NV
// edges of its edge table e (arrays of stride NVS; horizontal edges have
// eymin == eymax).
template <int NV, int NVS>
__device__ __forceinline__ uint32_t poly_row(const int* e, int gymax, int y,
                                             int W, uint32_t full) {
  constexpr int S = 2 * NV;           // each edge adds at most 2 crossings
  float ex0[NV], edx[NV];
  int eymin[NV], eymax[NV];
  load_floats<NV>(e, ex0);
  load_floats<NV>(e + NVS, edx);
  load_ints<NV>(e + 2 * NVS, eymin);
  load_ints<NV>(e + 3 * NVS, eymax);
  // edge x at row yy: the product rounds before the add
#define EDGE_X(k, yy) __fadd_rn(__fmul_rn((float)((yy) - eymin[k]), edx[k]), ex0[k])
  // per edge: its x at rows y and y -+ 1, and which of those it spans
  float cx[NV], cr[NV], xm[NV], xp[NV];
  bool horiz[NV], atend[NV], inm[NV], inp[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    horiz[k] = eymin[k] == eymax[k];
    cx[k] = EDGE_X(k, y);
    cr[k] = round_half_away(cx[k]);
    xm[k] = EDGE_X(k, y - 1);
    xp[k] = EDGE_X(k, y + 1);
    atend[k] = !horiz[k] && (y == eymin[k] || y == eymax[k]);
    inm[k] = y - 1 >= eymin[k] && y - 1 <= eymax[k];
    inp[k] = y + 1 >= eymin[k] && y + 1 <= eymax[k];
  }
#undef EDGE_X
  // Edge i's crossings: its x where it spans the row (replaced by the
  // corner fix-up's value where that applies) and, at its ymax above the
  // clipped bottom row, its x again. Pillow appends them in edge order and
  // sorts; the sort below sees the same values from fixed slots 2i, 2i + 1
  // (+inf where an edge adds none), so it gives the same sorted crossings.
  float xx[S];
  int j = 0;                         // the crossings' count
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool inr = !horiz[i] && y >= eymin[i] && y <= eymax[i];
    const bool at_ymax = inr && y == eymax[i];
    const bool at_ymin = inr && y == eymin[i];
    const bool dbl = at_ymax && y < gymax;
    float first = cx[i];
    // corner-connection fix-up (Draw.c: only at an endpoint row; at ymax only
    // on the clipped bottom row, where the doubling branch doesn't run)
    if (i > 0) {
      const bool elig = edx[i] != 0.0f && (at_ymin || (at_ymax && y >= gymax));
      const float adj = at_ymax ? xm[i] : xp[i];       // x at adj_y = y -+ 1
      bool found = false;
      float adj_o = 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) {
        const bool ok = atend[k] && cr[i] == cr[k] && (at_ymax ? inm[k] : inp[k]);
        adj_o = (ok && !found) ? (at_ymax ? xm[k] : xp[k]) : adj_o;
        found = found || ok;
      }
      const bool hi = cx[i] > __fadd_rn(adj, 1.0f) && cx[i] > __fadd_rn(adj_o, 1.0f);
      const bool lo = cx[i] < __fsub_rn(adj, 1.0f) && cx[i] < __fsub_rn(adj_o, 1.0f);
      const float r = round_half_away(hi ? fmaxf(adj, adj_o) : fminf(adj, adj_o));
      if (elig && found && (hi || lo)) first = hi ? __fadd_rn(r, 1.0f) : __fsub_rn(r, 1.0f);
    }
    xx[2 * i] = inr ? first : __int_as_float(0x7f800000);          // +inf
    xx[2 * i + 1] = dbl ? cx[i] : __int_as_float(0x7f800000);
    j += (inr ? 1 : 0) + (dbl ? 1 : 0);
  }
  // bitonic sort of all S slots, ascending (the +inf padding stays last)
#pragma unroll
  for (int k = 2; k <= S; k *= 2) {
#pragma unroll
    for (int m = k / 2; m > 0; m /= 2) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int l = i ^ m;
        if (l > i) {
          const float a = xx[i], b = xx[l];
          const bool up = (i & k) == 0;
          xx[i] = up ? fminf(a, b) : fmaxf(a, b);
          xx[l] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
  }
  // pair q fills where j >= 2 q + 2: pairs past the second only on rows
  // that cross more than 4 times
  uint32_t mask = 0u;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    mask |= span_bits(x_start(xx[2 * q]), x_end(xx[2 * q + 1]), j >= 2 * q + 2,
                      W, full);
  if (j > 4) {
#pragma unroll
    for (int q = 2; q < NV; ++q)
      mask |= span_bits(x_start(xx[2 * q]), x_end(xx[2 * q + 1]),
                        j >= 2 * q + 2, W, full);
  }
  // horizontal edges are hlined directly (ImagingDrawPolygon first loop)
  bool hit[NV], any = false;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    hit[i] = horiz[i] && y == eymin[i];
    any = any || hit[i];
  }
  if (any) {
    int hlo[NV], hhi[NV];
    load_ints<NV>(e + 4 * NVS, hlo);
    load_ints<NV>(e + 5 * NVS, hhi);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      mask |= span_bits((float)hlo[i], (float)hhi[i], hit[i], W, full);
  }
  return mask;
}

// One row of the tabulated PIL ellipse mask, shifted into image columns.
__device__ __forceinline__ uint32_t circle_row(const Tables& K, const int* slot,
                                               int ix0, int y, uint32_t full) {
  const int di = y - slot[HEAD_WORDS];
  const uint32_t bits = __ldg(K.tbl + slot[HEAD_WORDS + 1] + min(di, K.dmax + 1));
  uint32_t shifted;
  if (ix0 >= 0) shifted = ix0 < 32 ? bits << min(ix0, 31) : 0u;
  else shifted = -ix0 < 32 ? bits >> min(-ix0, 31) : 0u;
  return shifted & full;
}

// F frames of H inverted rows each, image order; `P.view(f)` places frame
// f's poses. G lanes a frame, blockDim.x / G frames a block, each frame
// frame_words(N, H, NV) words of dynamic shared memory.
template <int NV, class Poses>
__global__ void __launch_bounds__(THREADS)
raster_kernel(Poses P, Tables K, long F, int G, int32_t* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int slot = threadIdx.x / G, lane = threadIdx.x % G;
  const long f = (long)blockIdx.x * (blockDim.x / G) + slot;
  if (f >= F) return;                 // the whole tile: no sync spans tiles
  const unsigned tile = G == 32 ? 0xFFFFFFFFu
      : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int N = K.N, H = K.H, SW = slot_words(NV);
  int* fr = reinterpret_cast<int*>(smem) + (long)slot * frame_words(N, H, NV);
  uint32_t* rows = reinterpret_cast<uint32_t*>(fr);
  int* bodies = fr + ((H + 3) & ~3);
  for (int r = lane; r < H; r += G) rows[r] = 0u;
  frame_setup<NV>(K, P.view(f), lane, G, tile, bodies);
  __syncwarp(tile);
  const uint32_t full = full_bits(K.W);
  // the frame's (body, row) pairs, in body order: pair p goes to lane p %
  // G, and every lane of the tile runs the same passes
  int pairs = 0;
  for (int k = 0; k < N; ++k) pairs += bodies[k * SW + 1];
  for (int p0 = 0; p0 < pairs; p0 += G) {
    const int p = p0 + lane;
    if (p >= pairs) continue;
    int b = 0, start = 0, acc = 0;
    for (int k = 0; k < N; ++k) {
      const int n = bodies[k * SW + 1];
      const bool here = p >= acc && p < acc + n;
      b = here ? k : b;
      start = here ? acc : start;
      acc += n;
    }
    const int* sl = bodies + b * SW;
    const int4 h = reinterpret_cast<const int4*>(sl)[0];
    const int y = h.x + (p - start);
    uint32_t bits;
    if (h.z == ROW_CIRCLE)
      bits = circle_row(K, sl, h.w, y, full);
    else if (NV > 4 && h.z == ROW_POLY8)
      bits = poly_row<NV, NV>(sl + HEAD_WORDS, h.w, y, K.W, full);
    else
      bits = poly_row<4, NV>(sl + HEAD_WORDS, h.w, y, K.W, full);
    atomicOr(rows + y, bits);
  }
  __syncwarp(tile);
  for (int r = lane; r < H; r += G)
    out[f * H + r] = (int32_t)(rows[H - 1 - r] ^ full);
}

// Let raster_kernel<NV, Poses> take `shared` bytes of dynamic shared memory:
// beyond 48 KB a launch is refused unless the attribute was raised first.
// Raised once per instantiation, to the largest size asked so far.
template <int NV, class Poses>
cudaError_t allow_shared(int shared) {
  static int allowed = 0;
  if (shared <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      raster_kernel<NV, Poses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (e == cudaSuccess) allowed = shared;
  return e;
}

template <int NV, class Poses>
int launch_nv(const Poses& P, const Tables& K, long F, int G, int threads,
              int shared, int32_t* out, cudaStream_t stream) {
  const cudaError_t e = allow_shared<NV, Poses>(shared);
  if (e != cudaSuccess) return (int)e;
  const long fpb = threads / G;
  const long blocks = (F + fpb - 1) / fpb;
  raster_kernel<NV, Poses><<<(unsigned)blocks, threads, shared, stream>>>(
      P, K, F, G, out);
  return (int)cudaGetLastError();
}

// Launch F frames with the geometry render/cuda_raster.py launch_geometry
// gave (vertex bound NV, G lanes a frame, threads a block, dynamic shared
// bytes); a geometry the kernel does not take is refused before launching.
template <class Poses>
int launch(const Poses& P, const Tables& K, long F, int NV, int G,
           int threads, int shared, int32_t* out, void* stream) {
  const bool ok = F > 0 && K.N >= 0 && K.V > 0 && K.H > 0 && K.W > 0
      && K.W <= 32 && (NV == 4 || NV == 8) && G == tile_lanes(K.H, NV)
      && threads == THREADS
      && (long)shared == (long)(threads / G) * frame_words(K.N, K.H, NV) * 4
      && (F + threads / G - 1) / (threads / G) < (1L << 31);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return NV == 4 ? launch_nv<4>(P, K, F, G, threads, shared, out, s)
                 : launch_nv<8>(P, K, F, G, threads, shared, out, s);
}

}  // namespace lcd
