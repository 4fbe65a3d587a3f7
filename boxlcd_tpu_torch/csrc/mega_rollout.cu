// Rollout megakernel for Hopper (sm_90a): T env steps x `substeps` of the
// whole rigid-body pipeline for every world, in one launch. A group of G
// lanes owns one world (G = the spec's bodies rounded up to 4, 8, 16 or 32;
// lane i owns body i) and keeps its state across the T steps: its bodies'
// wall contacts in the lanes' registers, what the lanes share in the block's
// dynamic shared memory, sized by the spec (physics_stages.cuh's World). It
// writes each step's poses into the pose stream (T, N, 3, B), worlds minor:
// lane i stores body i's three rows, so the lanes of one body across a
// warp's worlds store neighbouring words. The final WorldState goes over its
// input (the wrapper passes copies).
//
// Replaces the TPU kernel of boxlcd_tpu/engine/mega.py (`kernel` of
// `_build_kernel(spec, T)`, launched by `make_rollout` through
// pl.pallas_call). That kernel unrolled one spec's topology into (8, 128)
// world tiles and was built per spec; here one build serves every env: the
// topology and constants come in as two small tables (physics_stages.cuh's
// SpecF / SpecI, built by engine/mega.py) that each block copies into shared
// memory, compile-time maxima cover the env zoo, and the kernel is
// instantiated for each group size. The stages are physics_stages.cuh's,
// after the port's plain torch physics (which the wrapper uses on the CPU and
// which chip_smoke.py holds the kernel against). Left out, as TPU tuning: the
// inert-block skip, the vel_iters >= 32 prefactor, the per-step DMA staging
// and the pad-to-block rule. With solver_exit_tol > 0 each world stops its
// velocity iterations on its own, as the plain version does.
//
// What bounds it on the H100: per world-substep it does a few thousand
// float operations (narrowphase, vel_iters Gauss-Seidel sweeps, pos_iters
// NGS) against a few hundred bytes of state moved once per launch, so its
// roofline bound is operations. What bounds it in fact is latency: each
// world is a dependent chain of those operations, so the card is fast only
// with many chains in flight and each chain short. The design shortens the
// chain (the body-parallel stages run on G lanes at once; only the joint and
// pair blocks stay serial, on one lane), keeps it out of local memory (no
// per-thread frame sized by the zoo's maxima) and spreads the worlds over
// every SM (engine/mega.py's launch_geometry: Urchin's 4000 worlds are 250
// blocks of 64 threads, 16 worlds a block). The next step's motor speeds are
// loaded while the current step runs. chip_smoke.py prints its time beside
// the bound, its registers and occupancy.

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
constexpr int MAX_THREADS = 128;

// Lane i loads body i's rows and wall contacts, lanes by pair and joint
// index the pair and joint carries.
template <unsigned G>
__device__ void load_state(const Group<G>& g, const Ptrs& P, const SpecI& I,
                           long wd, const World<G>& W, Own& o,
                           WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  if (i < n) {
    const long b = wd * n + i;
    W.sx(i) = P.c[2 * b]; W.sy(i) = P.c[2 * b + 1];
    W.sa(i) = P.a[b];
    o.vx = P.v[2 * b]; o.vy = P.v[2 * b + 1];
    o.w = P.w[b];
    W.sleep(i) = P.sleep[b];
    W.circ(i) = P.is_circle[b] != 0;
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= nw) break;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        wc[wi].imp[k][0] = P.wc_imp[2 * s];
        wc[wi].imp[k][1] = P.wc_imp[2 * s + 1];
        wc[wi].ids[k] = P.wc_id[s];
      }
    }
  }
  for (int p = i; p < np; p += G)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      W.pc[p].imp[k][0] = P.pc_imp[2 * s];
      W.pc[p].imp[k][1] = P.pc_imp[2 * s + 1];
      W.pc[p].ids[k] = P.pc_id[s];
    }
  for (int j = i; j < nj; j += G) {
    JointC& J = W.jc[j];
    const long s = wd * nj + j;
    J.imp[0] = P.j_imp[2 * s]; J.imp[1] = P.j_imp[2 * s + 1];
    J.mot = P.j_mot[s]; J.lim = P.j_lim[s];
    J.ref = P.j_ref[s]; J.prev_motor = P.prev_motor[s];
    J.state = P.j_state[s];
  }
}

template <unsigned G>
__device__ void store_state(const Group<G>& g, const Ptrs& P, const SpecI& I,
                            long wd, const World<G>& W, const Own& o,
                            const WallC (&wc)[MW]) {
  const int i = g.thread_rank(), n = I.n, nw = I.nw, np = I.np, nj = I.nj;
  if (i < n) {
    const long b = wd * n + i;
    P.c[2 * b] = W.sx(i); P.c[2 * b + 1] = W.sy(i);
    P.a[b] = W.sa(i);
    P.v[2 * b] = o.vx; P.v[2 * b + 1] = o.vy;
    P.w[b] = o.w;
    P.sleep[b] = W.sleep(i);
#pragma unroll
    for (int wi = 0; wi < MW; ++wi) {
      if (wi >= nw) break;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long s = (b * nw + wi) * 2 + k;
        P.wc_imp[2 * s] = wc[wi].imp[k][0];
        P.wc_imp[2 * s + 1] = wc[wi].imp[k][1];
        P.wc_id[s] = wc[wi].ids[k];
      }
    }
  }
  for (int p = i; p < np; p += G)
    for (int k = 0; k < 2; ++k) {
      const long s = (wd * np + p) * 2 + k;
      P.pc_imp[2 * s] = W.pc[p].imp[k][0];
      P.pc_imp[2 * s + 1] = W.pc[p].imp[k][1];
      P.pc_id[s] = W.pc[p].ids[k];
    }
  for (int j = i; j < nj; j += G) {
    const JointC& J = W.jc[j];
    const long s = wd * nj + j;
    P.j_imp[2 * s] = J.imp[0]; P.j_imp[2 * s + 1] = J.imp[1];
    P.j_mot[s] = J.mot; P.j_lim[s] = J.lim;
    P.prev_motor[s] = J.prev_motor;
    P.j_state[s] = J.state;
  }
}

// One world's T steps on its group. COUNT (the counted instance) keeps the
// NGS iterations the world ran in a register and adds them and its substeps
// to its row of `counts` (B, 2) once, at the end; the uncounted instance
// has no counting code.
template <unsigned G, bool COUNT>
__device__ __forceinline__ void rollout(const Ptrs& P, long B, int T, int wpb,
                                        long long* counts) {
  __shared__ SpecF F;
  __shared__ SpecI I;
  extern __shared__ float4 smem[];
  for (int k = threadIdx.x; k < NF; k += blockDim.x)
    reinterpret_cast<float*>(&F)[k] = P.ftab[k];
  for (int k = threadIdx.x; k < NI; k += blockDim.x)
    reinterpret_cast<int*>(&I)[k] = P.itab[k];
  __syncthreads();
  const Group<G> g = cg::tiled_partition<G>(cg::this_thread_block());
  const int slot = threadIdx.x / G, lane = g.thread_rank();
  const long wd = (long)blockIdx.x * wpb + slot;
  if (wd >= B) return;              // the whole group: no sync spans groups
  const World<G> W = world_view<G>(reinterpret_cast<float*>(smem), slot,
                                   I.np, I.nj);
  Own o = {0.0f, 0.0f, 0.0f};
  WallC wc[MW];
  load_state(g, P, I, wd, W, o, wc);
  g.sync();
  body_constants(g, F, I, W);
  const int n = I.n, nj = I.nj;
  // motor speeds: lane l holds joints l, l + G, ... of the next step
  constexpr int MQ = (MJ + G - 1) / G;
  float next[MQ];
#pragma unroll
  for (int q = 0; q < MQ; ++q) {
    const int j = lane + q * G;
    if (j < nj) W.jc[j].ms = P.motor_speed[wd * nj + j];
  }
  g.sync();
  int ngs = 0;
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
#pragma unroll
      for (int q = 0; q < MQ; ++q) {
        const int j = lane + q * G;
        if (j < nj) next[q] = P.motor_speed[((long)(t + 1) * B + wd) * nj + j];
      }
    }
    ngs += step(g, F, I, W, o, wc);
    if (lane < n) {
      float* out = P.stream + (long)t * n * 3 * B + wd;
      out[(3 * lane) * B] = W.sx(lane);
      out[(3 * lane + 1) * B] = W.sy(lane);
      out[(3 * lane + 2) * B] = W.sa(lane);
    }
    if (t + 1 < T) {
#pragma unroll
      for (int q = 0; q < MQ; ++q) {
        const int j = lane + q * G;
        if (j < nj) W.jc[j].ms = next[q];
      }
    }
    g.sync();
  }
  store_state(g, P, I, wd, W, o, wc);
  if constexpr (COUNT) {
    if (lane == 0) {
      counts[2 * wd] += ngs;
      counts[2 * wd + 1] += (long long)T * I.substeps;
    }
  }
}

template <unsigned G>
__global__ void __launch_bounds__(MAX_THREADS)
mega_rollout_kernel(Ptrs P, long B, int T, int wpb) {
  rollout<G, false>(P, B, T, wpb, nullptr);
}

template <unsigned G>
__global__ void __launch_bounds__(MAX_THREADS)
mega_rollout_counted_kernel(Ptrs P, long B, int T, int wpb,
                            long long* counts) {
  rollout<G, true>(P, B, T, wpb, counts);
}

// Let the kernel take `shared` bytes of dynamic shared memory: beyond 48 KB
// less its static shared memory (the tables) a launch is refused unless the
// attribute was raised first. Raised once per instantiation, to the largest
// size asked so far.
template <typename K>
cudaError_t allow_shared(K kern, int& allowed, int shared) {
  if (shared <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e == cudaSuccess) allowed = shared;
  return e;
}

template <unsigned G>
cudaError_t allow_shared(int shared) {
  static int allowed = 0;
  return allow_shared(mega_rollout_kernel<G>, allowed, shared);
}

template <unsigned G>
cudaError_t allow_shared_counted(int shared) {
  static int allowed = 0;
  return allow_shared(mega_rollout_counted_kernel<G>, allowed, shared);
}

template <unsigned G>
int launch_g(const Ptrs& P, long B, int T, int wpb, int shared,
             long long* counts, cudaStream_t stream) {
  const long blocks = (B + wpb - 1) / wpb;
  const cudaError_t e = counts ? allow_shared_counted<G>(shared)
                               : allow_shared<G>(shared);
  if (e != cudaSuccess) return (int)e;
  if (counts)
    mega_rollout_counted_kernel<G><<<(unsigned)blocks, G * wpb, shared,
                                     stream>>>(P, B, T, wpb, counts);
  else
    mega_rollout_kernel<G><<<(unsigned)blocks, G * wpb, shared, stream>>>(
        P, B, T, wpb);
  return (int)cudaGetLastError();
}

template <unsigned G>
int occupancy_g(int wpb, int shared) {
  int blocks = 0;
  cudaError_t e = allow_shared<G>(shared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mega_rollout_kernel<G>, G * wpb, shared);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Whether (G, wpb, np, nj, shared) is a geometry the kernel takes: a group
// size it is built for, at most MAX_THREADS threads, and the shared bytes
// its World layout needs.
bool geometry_ok(int G, int wpb, int np, int nj, int shared) {
  if (G != 4 && G != 8 && G != 16 && G != 32) return false;
  if (wpb <= 0 || G * wpb > MAX_THREADS) return false;
  return shared == wpb * world_words(G, np, nj) * 4;
}

}  // namespace

// Sizes of the spec tables in 4-byte words, for the wrapper's layout check.
extern "C" void mega_table_sizes(int* nf, int* ni) {
  *nf = NF;
  *ni = NI;
}

// ptrs: the 20 device pointers of Ptrs, in its order; the geometry from
// engine/mega.py's launch_geometry (group size G, worlds a block, the spec's
// pair and joint slots, dynamic shared bytes); counts: NULL for the
// uncounted instance, else a (B, 2) int64 device buffer the counted
// instance adds each world's NGS iterations and substeps into.
extern "C" int mega_rollout_launch(void* const* ptrs, long B, int T, int G,
                                   int wpb, int np, int nj, int shared,
                                   void* counts, void* stream) {
  if (B <= 0 || T <= 0 || !geometry_ok(G, wpb, np, nj, shared))
    return (int)cudaErrorInvalidValue;
  Ptrs P;
  static_assert(sizeof(Ptrs) == 20 * sizeof(void*), "Ptrs holds 20 pointers");
  memcpy(&P, ptrs, sizeof(Ptrs));
  cudaStream_t s = (cudaStream_t)stream;
  long long* c = (long long*)counts;
  switch (G) {
    case 4: return launch_g<4>(P, B, T, wpb, shared, c, s);
    case 8: return launch_g<8>(P, B, T, wpb, shared, c, s);
    case 16: return launch_g<16>(P, B, T, wpb, shared, c, s);
    default: return launch_g<32>(P, B, T, wpb, shared, c, s);
  }
}

// Resident blocks per SM for this geometry
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a cudaError.
extern "C" int mega_rollout_occupancy(int G, int wpb, int shared) {
  switch (G) {
    case 4: return occupancy_g<4>(wpb, shared);
    case 8: return occupancy_g<8>(wpb, shared);
    case 16: return occupancy_g<16>(wpb, shared);
    case 32: return occupancy_g<32>(wpb, shared);
    default: return -(int)cudaErrorInvalidValue;
  }
}
