// Rollout megakernel for Hopper (sm_90a): T env steps x `substeps` of the
// whole rigid-body pipeline for every world, in one launch. One thread owns
// one world and keeps its state in registers and local memory across the T
// steps; it writes each step's poses into the pose stream (T, N, 3, B),
// worlds minor, so a warp's stores coalesce, and the final WorldState over
// its input (the wrapper passes copies).
//
// Replaces the TPU kernel of boxlcd_tpu/engine/mega.py (`kernel` of
// `_build_kernel(spec, T)`, launched by `make_rollout` through
// pl.pallas_call). That kernel unrolled one spec's topology into (8, 128)
// world tiles and was built per spec; here one build serves every env: the
// topology and constants come in as two small tables (physics_stages.cuh's
// SpecF / SpecI, built by engine/mega.py) that each block copies into shared
// memory, and compile-time maxima cover the env zoo. The stages are
// physics_stages.cuh's, after the port's plain torch physics (which the
// wrapper uses on the CPU and which chip_smoke.py holds the kernel against).
// Left out, as TPU tuning: the inert-block skip, the vel_iters >= 32
// prefactor, the per-step DMA staging and the pad-to-block rule. With
// solver_exit_tol > 0 each world stops its velocity iterations on its own,
// as the plain version does.
//
// What bounds it on the H100: per world-substep it does a few thousand
// float operations (narrowphase, vel_iters Gauss-Seidel sweeps, pos_iters
// NGS) against a few hundred bytes of state moved once per launch, so its
// roofline bound is operations. What bounds it in fact is the serial
// dependency chain of the sweeps in one thread, local-memory traffic for
// the per-world arrays, and occupancy: the collection path's 4000 worlds are
// 32 blocks of 128 threads on 132 SMs. chip_smoke.py prints its time beside
// the bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "physics_stages.cuh"

namespace {

using namespace phys;

// Device pointers of one launch, each a (B, ...) tensor of WorldState in
// the port's layout, updated in place, plus the inputs and the stream.
struct Ptrs {
  const float* ftab;
  const int* itab;
  const uint8_t* is_circle;     // (B, N)
  float *c, *a, *v, *w, *sleep;  // (B, N, 2) / (B, N)
  float* wc_imp;                // (B, N, W, 2, 2)
  int* wc_id;                   // (B, N, W, 2)
  float* pc_imp;                // (B, P, 2, 2)
  int* pc_id;                   // (B, P, 2)
  float *j_imp, *j_mot, *j_lim, *j_ref, *prev_motor;  // (B, J, 2) / (B, J)
  int* j_state;                 // (B, J)
  const float* motor_speed;     // (T, B, J)
  float* stream;                // (T, N, 3, B)
};

constexpr int NF = sizeof(SpecF) / sizeof(float);
constexpr int NI = sizeof(SpecI) / sizeof(int);

__device__ void load_state(const Ptrs& P, const SpecI& I, long wd, State& S) {
  const int n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  for (int i = 0; i < n; ++i) {
    const long b = wd * n + i;
    S.cx[i] = P.c[2 * b]; S.cy[i] = P.c[2 * b + 1];
    S.a[i] = P.a[b];
    S.vx[i] = P.v[2 * b]; S.vy[i] = P.v[2 * b + 1];
    S.w[i] = P.w[b];
    S.sleep[i] = P.sleep[b];
    S.circ[i] = P.is_circle[b] != 0;
    for (int wi = 0; wi < nw; ++wi)
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        S.wc_imp[i][wi][k][0] = P.wc_imp[2 * s];
        S.wc_imp[i][wi][k][1] = P.wc_imp[2 * s + 1];
        S.wc_id[i][wi][k] = P.wc_id[s];
      }
  }
  for (int p = 0; p < np; ++p)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      S.pc_imp[p][k][0] = P.pc_imp[2 * s];
      S.pc_imp[p][k][1] = P.pc_imp[2 * s + 1];
      S.pc_id[p][k] = P.pc_id[s];
    }
  for (int j = 0; j < nj; ++j) {
    const long s = wd * nj + j;
    S.j_imp[j][0] = P.j_imp[2 * s]; S.j_imp[j][1] = P.j_imp[2 * s + 1];
    S.j_mot[j] = P.j_mot[s]; S.j_lim[j] = P.j_lim[s];
    S.j_ref[j] = P.j_ref[s]; S.prev_motor[j] = P.prev_motor[s];
    S.j_state[j] = P.j_state[s];
  }
}

__device__ void store_state(const Ptrs& P, const SpecI& I, long wd,
                            const State& S) {
  const int n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  for (int i = 0; i < n; ++i) {
    const long b = wd * n + i;
    P.c[2 * b] = S.cx[i]; P.c[2 * b + 1] = S.cy[i];
    P.a[b] = S.a[i];
    P.v[2 * b] = S.vx[i]; P.v[2 * b + 1] = S.vy[i];
    P.w[b] = S.w[i];
    P.sleep[b] = S.sleep[i];
    for (int wi = 0; wi < nw; ++wi)
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        P.wc_imp[2 * s] = S.wc_imp[i][wi][k][0];
        P.wc_imp[2 * s + 1] = S.wc_imp[i][wi][k][1];
        P.wc_id[s] = S.wc_id[i][wi][k];
      }
  }
  for (int p = 0; p < np; ++p)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      P.pc_imp[2 * s] = S.pc_imp[p][k][0];
      P.pc_imp[2 * s + 1] = S.pc_imp[p][k][1];
      P.pc_id[s] = S.pc_id[p][k];
    }
  for (int j = 0; j < nj; ++j) {
    const long s = wd * nj + j;
    P.j_imp[2 * s] = S.j_imp[j][0]; P.j_imp[2 * s + 1] = S.j_imp[j][1];
    P.j_mot[s] = S.j_mot[j]; P.j_lim[s] = S.j_lim[j];
    P.prev_motor[s] = S.prev_motor[j];
    P.j_state[s] = S.j_state[j];
  }
}

__global__ void __launch_bounds__(128) mega_rollout_kernel(Ptrs P, long B, int T) {
  __shared__ SpecF F;
  __shared__ SpecI I;
  for (int k = threadIdx.x; k < NF; k += blockDim.x)
    reinterpret_cast<float*>(&F)[k] = P.ftab[k];
  for (int k = threadIdx.x; k < NI; k += blockDim.x)
    reinterpret_cast<int*>(&I)[k] = P.itab[k];
  __syncthreads();
  const long wd = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (wd >= B) return;
  State S;
  Work X;
  load_state(P, I, wd, S);
  body_constants(F, I, S, X);
  const int n = I.n, nj = I.nj;
  float ms[MJ];
  for (int t = 0; t < T; ++t) {
    for (int j = 0; j < nj; ++j) ms[j] = P.motor_speed[((long)t * B + wd) * nj + j];
    step(F, I, ms, S, X);
    float* out = P.stream + (long)t * n * 3 * B + wd;
    for (int i = 0; i < n; ++i) {
      out[(3 * i) * B] = S.cx[i];
      out[(3 * i + 1) * B] = S.cy[i];
      out[(3 * i + 2) * B] = S.a[i];
    }
  }
  store_state(P, I, wd, S);
}

}  // namespace

// Sizes of the spec tables in 4-byte words, for the wrapper's layout check.
extern "C" void mega_table_sizes(int* nf, int* ni) {
  *nf = NF;
  *ni = NI;
}

// ptrs: the 20 device pointers of Ptrs, in its order.
extern "C" int mega_rollout_launch(void* const* ptrs, long B, int T,
                                   void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  Ptrs P;
  static_assert(sizeof(Ptrs) == 20 * sizeof(void*), "Ptrs holds 20 pointers");
  memcpy(&P, ptrs, sizeof(Ptrs));
  const int threads = 128;
  const long blocks = (B + threads - 1) / threads;
  mega_rollout_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      P, B, T);
  return (int)cudaGetLastError();
}
