// Whole-batch constraint solver for Hopper (sm_90a): the solver stages of one
// physics substep for every world, in one launch, between engine/physics.py's
// plain presolve and finalize. One thread owns one world.
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
// int fields to f32 for Mosaic; here each thread reads its world's rows of
// the (B, ...) tensors as physics.py builds them, in their own dtypes, and
// writes fresh output tensors (the wrapper allocates them), so the bundle
// the caller holds stays as it was. The stages are physics_stages.cuh's
// velocity_solve and position_solve, shared with mega_rollout.cu; topology
// and constants come from the same SpecF / SpecI tables (engine/mega.py),
// copied into shared memory per block, with the bundle's friction mixes in
// place of the table's. Every contact slot runs in the sweeps, as in the
// plain version: a slot without a velocity point carries zero masses and a
// zero impulse, so its updates are exact zeros.
//
// What bounds it on the H100: the bundle is read once and the carry written
// once, ~1 KB a world against ~10^4 float operations a substep, so its
// roofline bound is bytes at large batch. What bounds it in fact is the
// serial Gauss-Seidel chain in one thread, the Work scratch in local memory,
// and occupancy (4096 worlds are 32 blocks of 128 threads on 132 SMs).
// chip_smoke.py prints its time beside the bound.

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

__device__ void load_bundle(const Ptrs& P, const SpecI& I, long wd, Work& X,
                            float* ms) {
  const int n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  for (int i = 0; i < n; ++i) {
    const long b = wd * n + i;
    X.vx[i] = P.v[2 * b];
    X.vy[i] = P.v[2 * b + 1];
    X.w[i] = P.w[b];
    X.inv_m[i] = P.inv_m[b];
    X.inv_i[i] = P.inv_i[b];
    for (int wi = 0; wi < nw; ++wi) {
      WallC& C = X.wc[i][wi];
      const long s2 = b * nw + wi;
      C.k12 = P.w_k12[s2];
      C.block = P.w_block[s2] != 0;
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
  for (int p = 0; p < np; ++p) {
    PairC& C = X.pc[p];
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
      C.vtouch[k] = true;
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
  for (int j = 0; j < nj; ++j) {
    JointC& J = X.jc[j];
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
    X.j_imp[j][0] = P.j_imp[2 * s];
    X.j_imp[j][1] = P.j_imp[2 * s + 1];
    X.j_mot[j] = P.j_mot[s];
    X.j_lim[j] = P.j_lim[s];
    ms[j] = P.motor_speed[s];
  }
}

// The position solve's inputs: poses, reference angles, local centers and
// the manifold fields it re-evaluates.
__device__ void load_position(const Ptrs& P, const SpecI& I, long wd,
                              State& S, Work& X) {
  const int n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  for (int i = 0; i < n; ++i) {
    const long b = wd * n + i;
    S.cx[i] = P.c[2 * b];
    S.cy[i] = P.c[2 * b + 1];
    S.a[i] = P.a[b];
    X.lcx[i] = P.lc[2 * b];
    X.lcy[i] = P.lc[2 * b + 1];
    for (int wi = 0; wi < nw; ++wi) {
      WallC& C = X.wc[i][wi];
      const long s2 = b * nw + wi;
      C.rad_sub = P.w_rad[s2];
      for (int k = 0; k < 2; ++k) {
        const long s = s2 * 2 + k;
        C.touch[k] = P.w_touch[s] != 0;
        C.lpx[k] = P.w_lps[2 * s];
        C.lpy[k] = P.w_lps[2 * s + 1];
      }
    }
  }
  for (int p = 0; p < np; ++p) {
    PairC& C = X.pc[p];
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
  for (int j = 0; j < nj; ++j) S.j_ref[j] = P.j_ref[wd * nj + j];
}

__device__ void store_carry(const Ptrs& P, const SpecI& I, long wd,
                            const Work& X) {
  const int n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  for (int i = 0; i < n; ++i) {
    const long b = wd * n + i;
    P.v_out[2 * b] = X.vx[i];
    P.v_out[2 * b + 1] = X.vy[i];
    P.w_out[b] = X.w[i];
    for (int wi = 0; wi < nw; ++wi)
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        P.wc_out[2 * s] = X.wc[i][wi].imp[k][0];
        P.wc_out[2 * s + 1] = X.wc[i][wi].imp[k][1];
      }
  }
  for (int p = 0; p < np; ++p)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      P.pc_out[2 * s] = X.pc[p].imp[k][0];
      P.pc_out[2 * s + 1] = X.pc[p].imp[k][1];
    }
  for (int j = 0; j < nj; ++j) {
    const long s = wd * nj + j;
    P.j_imp_out[2 * s] = X.j_imp[j][0];
    P.j_imp_out[2 * s + 1] = X.j_imp[j][1];
    P.j_mot_out[s] = X.j_mot[j];
    P.j_lim_out[s] = X.j_lim[j];
  }
}

template <bool with_position>
__global__ void __launch_bounds__(128) batched_solver_kernel(Ptrs P, long B) {
  __shared__ SpecF F;
  __shared__ SpecI I;
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
  const long wd = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (wd >= B) return;
  Work X;
  float ms[MJ];
  load_bundle(P, I, wd, X, ms);
  velocity_solve(F, I, ms, X);
  if constexpr (with_position) {
    State S;
    load_position(P, I, wd, S, X);
    position_solve(F, I, S, X);
    for (int i = 0; i < I.n; ++i) {
      const long b = wd * I.n + i;
      P.c_out[2 * b] = X.cx[i];
      P.c_out[2 * b + 1] = X.cy[i];
      P.a_out[b] = X.a[i];
    }
  }
  store_carry(P, I, wd, X);
}

template <bool with_position>
int launch(void* const* ptrs, long B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  Ptrs P;
  memcpy(&P, ptrs, sizeof(Ptrs));
  const int threads = 128;
  const long blocks = (B + threads - 1) / threads;
  batched_solver_kernel<with_position>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(P, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Sizes of the spec tables in 4-byte words and of Ptrs in pointers, for the
// wrapper's layout check.
extern "C" void batched_solver_sizes(int* nf, int* ni, int* nptrs) {
  *nf = NF;
  *ni = NI;
  *nptrs = NPTRS;
}

// ptrs: the 64 device pointers of Ptrs, in its order.
extern "C" int batched_velocity_launch(void* const* ptrs, long B,
                                       void* stream) {
  return launch<false>(ptrs, B, stream);
}

extern "C" int batched_substep_launch(void* const* ptrs, long B,
                                      void* stream) {
  return launch<true>(ptrs, B, stream);
}
