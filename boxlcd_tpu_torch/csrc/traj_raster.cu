// Exact LCD frames for a whole (T, B) rollout for Hopper (sm_90a), from the
// rollout megakernel's pose stream; the frame core is lcd_common.cuh's
// raster_kernel.
//
// Replaces the TPU kernel of boxlcd_tpu/render/traj_raster.py (`kernel` of
// `make_kernel(sub)`, launched by `make_traj_render` through pl.pallas_call).
// Like that kernel it reads the pose stream as the megakernel writes it,
// here (T, N, 3, B) with worlds minor, so nothing is transposed between
// physics and raster; the per-world shape flags is_circle (B, N) are read
// per world, not broadcast over T. The TPU kernel's static circle select
// tree and its flipped-row space were Mosaic workarounds (no vector gather;
// a sublane reverse that miscompiled); here the circle rows come from the
// ellipse table and the flip is an index. Each frame equals the plain
// version (render/raster.py lcd_rows_plain) bit for bit. cos/sin of the
// angles come in precomputed (torch.cos/torch.sin outside the kernel), so
// kernel and plain version see the same bits.
//
// What bounds it on the H100: per frame it must read the poses (N * 16
// bytes: x, y, cos, sin; the angle row of the stream is never read) and
// write H * 4 bytes, plus is_circle once per world, so its roofline bound
// is bytes: tens of microseconds at the collection path's 100 steps x 4000
// worlds. What bounds it in fact is instruction issue: the polygon rows'
// scalar edge arithmetic. The design (lcd_common.cuh) does the frame setup
// once per body and computes only the (body, row) pairs where a body is,
// with every per-row array in registers.
// Frame f is step f / B, world f % B, so a block's frames are consecutive
// worlds at one step and its pose loads run along the worlds-minor axis.

#include "lcd_common.cuh"

// Frame f = t * B + w: body b's x at poses[t, b, 0, w], y at poses[t, b, 1,
// w], cos and sin at [t, b, w], is_circle at [w, b].
struct TrajPoses {
  const float* poses;
  const float* cosa;
  const float* sina;
  const uint8_t* is_circle;
  long B;
  int N;
  __device__ lcd::PoseView view(long f) const {
    const long t = f / B, w = f % B;
    const float* x = poses + t * N * 3 * B + w;
    const long o = t * N * B + w;
    return {x, x + B, cosa + o, sina + o, is_circle + w * N, 3 * B, B};
  }
};

// geometry: render/cuda_raster.py launch_geometry (vertex bound nv, lanes a
// frame, threads a block, dynamic shared bytes) for T * B frames.
extern "C" int traj_raster_launch(
    const void* poses, const void* cosa, const void* sina,
    const void* is_circle, const void* shape_static, const void* nverts,
    const void* radius, const void* draw_verts, const void* lc,
    const void* tbl, long T, long B, int N, int V, int H, int W, int dmax,
    float s, int nv, int lanes, int threads, int shared, void* out,
    void* stream) {
  if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const TrajPoses P{(const float*)poses, (const float*)cosa,
                    (const float*)sina, (const uint8_t*)is_circle, B, N};
  const lcd::Tables K{(const int*)shape_static, (const int*)nverts,
                      (const float*)radius, (const float*)draw_verts,
                      (const float*)lc, (const uint32_t*)tbl,
                      N, V, H, W, dmax, s};
  return lcd::launch(P, K, T * B, nv, lanes, threads, shared, (int32_t*)out,
                     stream);
}
