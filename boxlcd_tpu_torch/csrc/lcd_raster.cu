// Exact batched LCD raster for Hopper (sm_90a): one thread per (world, image
// row) builds that row's 32-bit mask over all bodies, inverts it and writes it.
//
// Replaces the TPU kernel of boxlcd_tpu/render/pallas_raster.py (`kernel`,
// launched by `make_batched_render` through pl.pallas_call). That kernel held
// worlds on the 128 lanes and rows on the sublanes, and left the vertex
// transform, the circle table gathers and the RANDOM-shape select to XLA
// around it; here all of that folds into the one kernel, so a launch reads
// only the poses and writes only the frames.
//
// What it computes, bit for bit like Pillow (and like the plain torch version
// in render/raster.py): each polygon body is transformed in b2Mul float32 op
// order, truncated to integer pixels and scanline-filled with Pillow's
// polygon_generic rules (edge intersections in float32, endpoint doubling,
// the corner-connection fix-up, sort + pair fill with floor(x+0.5) /
// round-half-toward-zero span ends, hlines for horizontal edges); each circle
// body ORs in its row of the tabulated PIL ellipse mask; RANDOM bodies pick
// one of the two by is_circle (device functions in lcd_common.cuh, shared
// with traj_raster.cu). The build uses --fmad=false and IEEE division
// (nvcc's default -prec-div=true): an FMA in the vertex transform or in the
// edge intersection flips pixels at span edges.
//
// What bounds it on the H100: per world it must read only the poses
// (N * 17 bytes) and write H * 4 bytes, so its roofline bound is bytes, a
// fraction of a microsecond at the collection path's 4000 worlds. What
// bounds it in fact is latency and instruction issue: each row runs a few
// hundred dependent scalar instructions per polygon body (edge table,
// fix-up, sort), and 4000 worlds x 16 rows is less than one wave of the
// card. The design keeps everything in registers and local arrays (no shared
// memory, no atomics, no per-spec build), uses one independent thread per
// row so that large batches fill every SM, and writes each world's rows
// contiguously so the stores coalesce. chip_smoke.py prints its time beside
// the bound.

#include "lcd_common.cuh"

namespace {

__global__ void lcd_raster_kernel(
    const uint8_t* __restrict__ is_circle,     // (B, N) bool
    const float* __restrict__ c,               // (B, N, 2) centers of mass
    const float* __restrict__ cosa,            // (B, N)
    const float* __restrict__ sina,            // (B, N)
    const int* __restrict__ shape_static,      // (N,) CIRCLE | POLY | RANDOM
    const int* __restrict__ nverts,            // (N,)
    const float* __restrict__ radius,          // (N,)
    const float* __restrict__ draw_verts,      // (N, V, 2)
    const float* __restrict__ lc,              // (N, 2) polygon-variant local center
    const uint32_t* __restrict__ tbl,          // (dmax+1, dmax+1, dmax+2) ellipse rows
    long B, int N, int V, int H, int W, int dmax, float s,
    int32_t* __restrict__ out) {               // (B, H) inverted rows, image order
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * H) return;
  const long w = idx / H;
  const int row = (int)(idx % H);
  const int y = H - 1 - row;                  // PIL frame row (vertical flip)
  const uint32_t full = lcd::full_bits(W);
  const lcd::BodyTables K{shape_static, nverts, radius, draw_verts, lc, tbl,
                          V, dmax, s};
  uint32_t mask = 0u;
  for (int b = 0; b < N; ++b) {
    const long wb = w * N + b;
    mask |= lcd::body_row(K, b, is_circle[wb] != 0, c[2 * wb], c[2 * wb + 1],
                          cosa[wb], sina[wb], y, H, W, full);
  }
  out[idx] = (int32_t)(mask ^ full);
}

}  // namespace

extern "C" int lcd_raster_launch(
    const void* is_circle, const void* c, const void* cosa, const void* sina,
    const void* shape_static, const void* nverts, const void* radius,
    const void* draw_verts, const void* lc, const void* tbl,
    long B, int N, int V, int H, int W, int dmax, float s, void* out,
    void* stream) {
  if (V > LCD_MAXV || W > 32 || B <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = (B * H + threads - 1) / threads;
  lcd_raster_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)is_circle, (const float*)c, (const float*)cosa,
      (const float*)sina, (const int*)shape_static, (const int*)nverts,
      (const float*)radius, (const float*)draw_verts, (const float*)lc,
      (const uint32_t*)tbl, B, N, V, H, W, dmax, s, (int32_t*)out);
  return (int)cudaGetLastError();
}
