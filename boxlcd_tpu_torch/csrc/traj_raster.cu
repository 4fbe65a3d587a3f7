// Exact LCD frames for a whole (T, B) rollout for Hopper (sm_90a): one thread
// per (step, world, image row) builds that row's 32-bit mask over all bodies,
// inverts it and writes it.
//
// Replaces the TPU kernel of boxlcd_tpu/render/traj_raster.py (`kernel` of
// `make_kernel(sub)`, launched by `make_traj_render` through pl.pallas_call).
// Like that kernel it reads the rollout megakernel's pose stream as the
// megakernel writes it, here (T, N, 3, B) with worlds minor, so nothing is
// transposed between physics and raster; the per-world shape flags
// is_circle (B, N) are read once per world, not broadcast over T. The TPU
// kernel's static circle select tree and its flipped-row space were Mosaic
// workarounds (no vector gather; a sublane reverse that miscompiled); here
// the circle rows come from the same table lookup as lcd_raster.cu and the
// flip is an index. The per-body arithmetic is lcd_common.cuh's, so each
// frame equals the plain version (render/raster.py lcd_rows_plain) bit for
// bit. cos/sin of the angles come in precomputed (torch.cos/torch.sin
// outside the kernel), so kernel and plain version see the same bits.
//
// What bounds it on the H100: per frame it must read the poses (N * 20
// bytes: x, y, angle, cos, sin) and write H * 4 bytes, plus is_circle once
// per world, so its roofline bound is bytes: tens of microseconds at the
// collection path's 100 steps x 4000 worlds. What bounds it in fact is the
// scalar edge loop per row and polygon (latency and instruction issue), as
// for lcd_raster.cu. A launch has T * B * H threads, many waves at the main
// path's shape, and consecutive threads write consecutive rows of a frame,
// so the stores coalesce.

#include "lcd_common.cuh"

namespace {

__global__ void traj_raster_kernel(
    const float* __restrict__ poses,           // (T, N, 3, B) x, y, angle
    const float* __restrict__ cosa,            // (T, N, B)
    const float* __restrict__ sina,            // (T, N, B)
    const uint8_t* __restrict__ is_circle,     // (B, N) bool
    lcd::BodyTables K, long T, long B, int N, int H, int W,
    int32_t* __restrict__ out) {               // (T, B, H) inverted rows, image order
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * B * H) return;
  const long tw = idx / H;                    // t * B + w
  const int row = (int)(idx % H);
  const long t = tw / B, w = tw % B;
  const int y = H - 1 - row;                  // PIL frame row (vertical flip)
  const uint32_t full = lcd::full_bits(W);
  uint32_t mask = 0u;
  for (int b = 0; b < N; ++b) {
    const long pb = (t * N + b) * 3 * B + w;  // x at pb, y at pb + B
    const long tb = (t * N + b) * B + w;
    mask |= lcd::body_row(K, b, is_circle[w * N + b] != 0, poses[pb],
                          poses[pb + B], cosa[tb], sina[tb], y, H, W, full);
  }
  out[idx] = (int32_t)(mask ^ full);
}

}  // namespace

extern "C" int traj_raster_launch(
    const void* poses, const void* cosa, const void* sina,
    const void* is_circle, const void* shape_static, const void* nverts,
    const void* radius, const void* draw_verts, const void* lc,
    const void* tbl, long T, long B, int N, int V, int H, int W, int dmax,
    float s, void* out, void* stream) {
  if (V > LCD_MAXV || W > 32 || T <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const lcd::BodyTables K{(const int*)shape_static, (const int*)nverts,
                          (const float*)radius, (const float*)draw_verts,
                          (const float*)lc, (const uint32_t*)tbl, V, dmax, s};
  const int threads = 256;
  const long blocks = (T * B * H + threads - 1) / threads;
  traj_raster_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float*)cosa, (const float*)sina,
      (const uint8_t*)is_circle, K, T, B, N, H, W, (int32_t*)out);
  return (int)cudaGetLastError();
}
