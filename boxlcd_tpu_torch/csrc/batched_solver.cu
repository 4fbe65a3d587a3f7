// Whole-batch constraint solver for Hopper (sm_90a): the solver stages of one
// physics substep for every world, in one launch, between engine/physics.py's
// plain presolve and finalize. A group of G lanes owns one world (lane i owns
// body i), as in mega_rollout.cu.
//
//   with_position = false: `vel_iters` Gauss-Seidel velocity sweeps (joint
//     motor, the coupled limit + point block, wall and pair friction, the
//     2-point block LCP) over the SolveBundle (velocity_solver hook);
//   with_position = true: the same, then position integration and `pos_iters`
//     NGS with Box2D's per-world exit (substep_solver hook).
//
// Replaces the TPU kernels of boxlcd_tpu/engine/pallas_solver.py
// (`_make_kernel(spec, with_position)`, launched through pl.pallas_call by
// `make_batched_solver` and `make_substep_solver`). Those laid every bundle
// field out as (*S, B/128, 128) tiles of 1024 worlds and converted bool and
// int fields to f32 for Mosaic; here the kernel reads the (B, ...) tensors as
// physics.py builds them, in their own dtypes, and writes fresh output
// tensors (the wrapper allocates them), so the bundle the caller holds stays
// as it was. The stages are physics_stages.cuh's velocity_solve and
// position_solve, shared with mega_rollout.cu; topology and constants come
// from the same SpecF / SpecI tables (engine/mega.py), copied into shared
// memory per block, with the bundle's friction mixes in place of the
// table's. Every contact slot runs in the sweeps, as in the plain version: a
// slot without a velocity point carries zero masses and a zero impulse, so
// its updates are exact zeros.
//
// What bounds it on the H100: the bundle is read once and the carry written
// once, ~1 KB a world against ~10^4 float operations a substep, so its
// roofline bound is bytes at large batch. What bounds it in fact is the
// latency of the Gauss-Seidel chain and of the loads that start it. Lane i
// reads its own body's rows of the (B, N, ...) fields, so a warp's loads of
// one field cover one contiguous run of its worlds' rows; pair and joint
// rows are read by lanes in slot order. The body-parallel stages run on G
// lanes at once, the wall contacts stay in registers, and
// engine/mega.py's launch_geometry spreads the worlds over every SM (Urchin's
// 4096 worlds are 256 blocks of 64 threads). chip_smoke.py prints its time
// beside the bound, its registers and occupancy.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "physics_stages.cuh"

namespace {

using namespace phys;

// Device pointers of one launch, each a (B, ...) tensor in physics.py's
// layout unless marked; the velocity kernel leaves the position inputs and
// c_out / a_out null.
struct Ptrs {
  const float* ftab;
  const int* itab;
  // the SolveBundle, in its field order
  const float *v, *w, *j_imp, *j_mot, *j_lim, *wc, *pc;
  const float *inv_m, *inv_i, *j_rA, *j_rB, *j_axmass;
  const int* j_state;
  const float *j_mA, *j_mB, *j_iA, *j_iB, *motor_speed;
  const float *w_rB, *w_nmass, *w_tmass, *w_bias;
  const float* w_mu;              // (N,): a spec constant
  const float *w_k, *w_k12;
  const uint8_t* w_block;         // (B, N, W) bool
  const float *p_n, *p_rA, *p_rB, *p_nmass, *p_tmass, *p_bias;
  const float* p_mu;              // (P,): a spec constant
  const float *p_imA, *p_imB, *p_iiA, *p_iiB, *p_k, *p_k12;
  const uint8_t* p_block;         // (B, P) bool
  // the position solve's inputs: states.c / a / j_ref, the manifolds, lc
  const float *c, *a, *j_ref, *lc;
  const float *w_lps, *w_rad;     // (B, N, W, 2, 2), (B, N, W)
  const uint8_t* w_touch;         // (B, N, W, 2) bool
  const float *p_lps, *p_ln, *p_lpp, *p_rad;
  const int* p_mtype;             // (B, P) int32
  const uint8_t* p_touch;         // (B, P, 2) bool
  // outputs
  float *v_out, *w_out, *j_imp_out, *j_mot_out, *j_lim_out, *wc_out, *pc_out;
  float *c_out, *a_out;
};

constexpr int NPTRS = 2 + 40 + 13 + 9;
static_assert(sizeof(Ptrs) == NPTRS * sizeof(void*), "Ptrs holds 64 pointers");

constexpr int NF = sizeof(SpecF) / sizeof(float);
constexpr int NI = sizeof(SpecI) / sizeof(int);
constexpr int MAX_THREADS = 128;

template <unsigned G>
__device__ void load_bundle(const Group<G>& g, const Ptrs& P, const SpecI& I,
                            long wd, const World<G>& W, WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  if (i < n) {
    const long b = wd * n + i;
    W.vx(i) = P.v[2 * b];
    W.vy(i) = P.v[2 * b + 1];
    W.w(i) = P.w[b];
    W.im(i) = P.inv_m[b];
    W.ii(i) = P.inv_i[b];
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= nw) break;
      WallC& C = wc[wi];
      const long s2 = b * nw + wi;
      C.k12 = P.w_k12[s2];
      C.block = P.w_block[s2] != 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long s = s2 * 2 + k;
        C.vtouch[k] = true;
        C.rbx[k] = P.w_rB[2 * s];
        C.rby[k] = P.w_rB[2 * s + 1];
        C.nmass[k] = P.w_nmass[s];
        C.tmass[k] = P.w_tmass[s];
        C.bias[k] = P.w_bias[s];
        C.kn[k] = P.w_k[s];
        C.imp[k][0] = P.wc[2 * s];
        C.imp[k][1] = P.wc[2 * s + 1];
      }
    }
  }
  for (int p = i; p < np; p += G) {
    PairC& C = W.pc[p];
    const long s1 = wd * np + p;
    C.nx = P.p_n[2 * s1];
    C.ny = P.p_n[2 * s1 + 1];
    C.k12 = P.p_k12[s1];
    C.block = P.p_block[s1] != 0;
    C.imA = P.p_imA[s1];
    C.imB = P.p_imB[s1];
    C.iiA = P.p_iiA[s1];
    C.iiB = P.p_iiB[s1];
    for (int k = 0; k < 2; ++k) {
      const long s = s1 * 2 + k;
      C.vtouch[k] = 1;
      C.rax[k] = P.p_rA[2 * s];
      C.ray[k] = P.p_rA[2 * s + 1];
      C.rbx[k] = P.p_rB[2 * s];
      C.rby[k] = P.p_rB[2 * s + 1];
      C.nmass[k] = P.p_nmass[s];
      C.tmass[k] = P.p_tmass[s];
      C.bias[k] = P.p_bias[s];
      C.kn[k] = P.p_k[s];
      C.imp[k][0] = P.pc[2 * s];
      C.imp[k][1] = P.pc[2 * s + 1];
    }
  }
  for (int j = i; j < nj; j += G) {
    JointC& J = W.jc[j];
    const long s = wd * nj + j;
    J.rax = P.j_rA[2 * s];
    J.ray = P.j_rA[2 * s + 1];
    J.rbx = P.j_rB[2 * s];
    J.rby = P.j_rB[2 * s + 1];
    J.axmass = P.j_axmass[s];
    J.mA = P.j_mA[s];
    J.mB = P.j_mB[s];
    J.iA = P.j_iA[s];
    J.iB = P.j_iB[s];
    J.state = P.j_state[s];
    J.imp[0] = P.j_imp[2 * s];
    J.imp[1] = P.j_imp[2 * s + 1];
    J.mot = P.j_mot[s];
    J.lim = P.j_lim[s];
    J.ms = P.motor_speed[s];
  }
}

// The position solve's inputs: poses, reference angles, local centers and
// the manifold fields it re-evaluates.
template <unsigned G>
__device__ void load_position(const Group<G>& g, const Ptrs& P,
                              const SpecI& I, long wd, const World<G>& W,
                              WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  if (i < n) {
    const long b = wd * n + i;
    W.sx(i) = P.c[2 * b];
    W.sy(i) = P.c[2 * b + 1];
    W.sa(i) = P.a[b];
    W.lcx(i) = P.lc[2 * b];
    W.lcy(i) = P.lc[2 * b + 1];
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= nw) break;
      WallC& C = wc[wi];
      const long s2 = b * nw + wi;
      C.rad_sub = P.w_rad[s2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long s = s2 * 2 + k;
        C.touch[k] = P.w_touch[s] != 0;
        C.lpx[k] = P.w_lps[2 * s];
        C.lpy[k] = P.w_lps[2 * s + 1];
      }
    }
  }
  for (int p = i; p < np; p += G) {
    PairC& C = W.pc[p];
    const long s1 = wd * np + p;
    C.mtype = P.p_mtype[s1];
    C.rad_sub = P.p_rad[s1];
    C.lnx = P.p_ln[2 * s1];
    C.lny = P.p_ln[2 * s1 + 1];
    C.lppx = P.p_lpp[2 * s1];
    C.lppy = P.p_lpp[2 * s1 + 1];
    for (int k = 0; k < 2; ++k) {
      const long s = s1 * 2 + k;
      C.touch[k] = P.p_touch[s] != 0;
      C.lpsx[k] = P.p_lps[2 * s];
      C.lpsy[k] = P.p_lps[2 * s + 1];
    }
  }
  for (int j = i; j < nj; j += G) W.jc[j].ref = P.j_ref[wd * nj + j];
}

template <unsigned G>
__device__ void store_carry(const Group<G>& g, const Ptrs& P, const SpecI& I,
                            long wd, const World<G>& W,
                            const WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  if (i < n) {
    const long b = wd * n + i;
    P.v_out[2 * b] = W.vx(i);
    P.v_out[2 * b + 1] = W.vy(i);
    P.w_out[b] = W.w(i);
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= nw) break;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        P.wc_out[2 * s] = wc[wi].imp[k][0];
        P.wc_out[2 * s + 1] = wc[wi].imp[k][1];
      }
    }
  }
  for (int p = i; p < np; p += G)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      P.pc_out[2 * s] = W.pc[p].imp[k][0];
      P.pc_out[2 * s + 1] = W.pc[p].imp[k][1];
    }
  for (int j = i; j < nj; j += G) {
    const JointC& J = W.jc[j];
    const long s = wd * nj + j;
    P.j_imp_out[2 * s] = J.imp[0];
    P.j_imp_out[2 * s + 1] = J.imp[1];
    P.j_mot_out[s] = J.mot;
    P.j_lim_out[s] = J.lim;
  }
}

template <unsigned G, bool with_position>
__global__ void __launch_bounds__(MAX_THREADS)
batched_solver_kernel(Ptrs P, long B, int wpb) {
  __shared__ SpecF F;
  __shared__ SpecI I;
  extern __shared__ float4 smem[];
  for (int k = threadIdx.x; k < NF; k += blockDim.x)
    reinterpret_cast<float*>(&F)[k] = P.ftab[k];
  for (int k = threadIdx.x; k < NI; k += blockDim.x)
    reinterpret_cast<int*>(&I)[k] = P.itab[k];
  __syncthreads();
  // the bundle's friction mixes replace the table's (the same values when
  // the bundle comes from physics._presolve)
  for (int k = threadIdx.x; k < I.n; k += blockDim.x) F.w_mu[k] = P.w_mu[k];
  for (int k = threadIdx.x; k < I.np; k += blockDim.x) F.p_mu[k] = P.p_mu[k];
  __syncthreads();
  const Group<G> g = cg::tiled_partition<G>(cg::this_thread_block());
  const int slot = threadIdx.x / G;
  const long wd = (long)blockIdx.x * wpb + slot;
  if (wd >= B) return;              // the whole group: no sync spans groups
  const World<G> W = world_view<G>(reinterpret_cast<float*>(smem), slot,
                                   I.np, I.nj);
  WallC wc[MW];
  load_bundle(g, P, I, wd, W, wc);
  if constexpr (with_position) load_position(g, P, I, wd, W, wc);
  g.sync();
  velocity_solve(g, F, I, W, wc);
  if constexpr (with_position) {
    position_solve(g, F, I, W, wc);
    const int i = g.thread_rank();
    if (i < I.n) {
      const long b = wd * I.n + i;
      P.c_out[2 * b] = W.cx(i);
      P.c_out[2 * b + 1] = W.cy(i);
      P.a_out[b] = W.a(i);
    }
  }
  store_carry(g, P, I, wd, W, wc);
}

// Let the kernel take `shared` bytes of dynamic shared memory: beyond 48 KB
// less its static shared memory (the tables) a launch is refused unless the
// attribute was raised first. Raised once per instantiation, to the largest
// size asked so far.
template <unsigned G, bool with_position>
cudaError_t allow_shared(int shared) {
  static int allowed = 0;
  if (shared <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      batched_solver_kernel<G, with_position>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e == cudaSuccess) allowed = shared;
  return e;
}

template <unsigned G, bool with_position>
int launch_g(const Ptrs& P, long B, int wpb, int shared, cudaStream_t stream) {
  auto kern = batched_solver_kernel<G, with_position>;
  const cudaError_t e = allow_shared<G, with_position>(shared);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (B + wpb - 1) / wpb;
  kern<<<(unsigned)blocks, G * wpb, shared, stream>>>(P, B, wpb);
  return (int)cudaGetLastError();
}

template <unsigned G, bool with_position>
int occupancy_g(int wpb, int shared) {
  int blocks = 0;
  cudaError_t e = allow_shared<G, with_position>(shared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, batched_solver_kernel<G, with_position>, G * wpb, shared);
  return e == cudaSuccess ? blocks : -(int)e;
}

bool geometry_ok(int G, int wpb, int np, int nj, int shared) {
  if (G != 4 && G != 8 && G != 16 && G != 32) return false;
  if (wpb <= 0 || G * wpb > MAX_THREADS) return false;
  return shared == wpb * world_words(G, np, nj) * 4;
}

template <bool with_position>
int launch(void* const* ptrs, long B, int G, int wpb, int np, int nj,
           int shared, void* stream) {
  if (B <= 0 || !geometry_ok(G, wpb, np, nj, shared))
    return (int)cudaErrorInvalidValue;
  Ptrs P;
  memcpy(&P, ptrs, sizeof(Ptrs));
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 4: return launch_g<4, with_position>(P, B, wpb, shared, s);
    case 8: return launch_g<8, with_position>(P, B, wpb, shared, s);
    case 16: return launch_g<16, with_position>(P, B, wpb, shared, s);
    default: return launch_g<32, with_position>(P, B, wpb, shared, s);
  }
}

template <bool with_position>
int occupancy(int G, int wpb, int shared) {
  switch (G) {
    case 4: return occupancy_g<4, with_position>(wpb, shared);
    case 8: return occupancy_g<8, with_position>(wpb, shared);
    case 16: return occupancy_g<16, with_position>(wpb, shared);
    case 32: return occupancy_g<32, with_position>(wpb, shared);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Sizes of the spec tables in 4-byte words and of Ptrs in pointers, for the
// wrapper's layout check.
extern "C" void batched_solver_sizes(int* nf, int* ni, int* nptrs) {
  *nf = NF;
  *ni = NI;
  *nptrs = NPTRS;
}

// ptrs: the 64 device pointers of Ptrs, in its order; the geometry from
// engine/mega.py's launch_geometry, as for mega_rollout_launch.
extern "C" int batched_velocity_launch(void* const* ptrs, long B, int G,
                                       int wpb, int np, int nj, int shared,
                                       void* stream) {
  return launch<false>(ptrs, B, G, wpb, np, nj, shared, stream);
}

extern "C" int batched_substep_launch(void* const* ptrs, long B, int G,
                                      int wpb, int np, int nj, int shared,
                                      void* stream) {
  return launch<true>(ptrs, B, G, wpb, np, nj, shared, stream);
}

// Resident blocks per SM of either kernel for this geometry, or minus a
// cudaError.
extern "C" int batched_solver_occupancy(int with_position, int G, int wpb,
                                        int shared) {
  return with_position ? occupancy<true>(G, wpb, shared)
                       : occupancy<false>(G, wpb, shared);
}
