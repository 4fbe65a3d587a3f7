// Exact batched LCD raster for Hopper (sm_90a): one frame per world, from
// (B, N) poses; the frame core is lcd_common.cuh's raster_kernel.
//
// Replaces the TPU kernel of boxlcd_tpu/render/pallas_raster.py (`kernel`,
// launched by `make_batched_render` through pl.pallas_call). That kernel held
// worlds on the 128 lanes and rows on the sublanes, and left the vertex
// transform, the circle table gathers and the RANDOM-shape select to XLA
// around it; here all of that folds into the one kernel, so a launch reads
// only the poses and writes only the frames, each bit for bit the plain
// version's (render/raster.py lcd_rows_plain).
//
// What bounds it on the H100: per world it must read only the poses
// (N * 17 bytes) and write H * 4 bytes, so its roofline bound is bytes, a
// fraction of a microsecond at the collection path's 4000 worlds. What
// bounds it in fact is one frame's dependent chain (the per-step paths
// launch it on 8-4096 worlds, less than a wave of the card) and, at large
// batches, instruction issue. The design (lcd_common.cuh) does the frame
// setup once per body, split over the frame's G lanes, computes only the
// (body, row) pairs where a body is, dealt out over those lanes, and keeps
// every per-row array in registers.

#include "lcd_common.cuh"

// World f's body b at f * N + b: is_circle (B, N), c (B, N, 2), cos and sin
// (B, N).
struct FramePoses {
  const uint8_t* is_circle;
  const float* c;
  const float* cosa;
  const float* sina;
  int N;
  __device__ lcd::PoseView view(long f) const {
    const long o = f * N;
    return {c + 2 * o, c + 2 * o + 1, cosa + o, sina + o, is_circle + o, 2, 1};
  }
};

// geometry: render/cuda_raster.py launch_geometry (vertex bound nv, lanes a
// frame, threads a block, dynamic shared bytes).
extern "C" int lcd_raster_launch(
    const void* is_circle, const void* c, const void* cosa, const void* sina,
    const void* shape_static, const void* nverts, const void* radius,
    const void* draw_verts, const void* lc, const void* tbl,
    long B, int N, int V, int H, int W, int dmax, float s, int nv, int lanes,
    int threads, int shared, void* out, void* stream) {
  const FramePoses P{(const uint8_t*)is_circle, (const float*)c,
                     (const float*)cosa, (const float*)sina, N};
  const lcd::Tables K{(const int*)shape_static, (const int*)nverts,
                      (const float*)radius, (const float*)draw_verts,
                      (const float*)lc, (const uint32_t*)tbl,
                      N, V, H, W, dmax, s};
  return lcd::launch(P, K, B, nv, lanes, threads, shared, (int32_t*)out,
                     stream);
}
