// The grouped-expert GEMMs of a mixture-of-experts layer (DeepSeek-V2's
// routed experts): for the token-slots sorted by expert, silu(x Wg^T) *
// (x Wu^T) into h, then h Wd^T into each slot's row of y, as two launches
// over the experts a layer holds. The wrapper and the rest of the layer
// (routing, the sort, the weighted combine) are research/nets/moe_kernel.py.
//
// It replaces no TPU kernel: the JAX package has no mixture of experts. At
// the dream's 3,200 tokens a step each of 64 experts takes ~300 of the
// 19,200 token-slots in each of 26 layers; a loop over experts would
// enqueue ~5,000 launches a step and read the counts back to the host.
//
// What bounds it on an H100: a layer reads its experts' weights once
// (64 x 3 x 2048 x 1408 bf16, 1.107 GB: 0.331 ms at 3.35 TB/s) and does
// 2 x 19,200 x 3 x 2048 x 1408 operations (0.336 ms at 989 TFLOP/s): at
// ~300 rows an expert it sits on the ridge point. The design:
// - the grid is sized for the worst case, ceil(slots / BM) + experts row
//   tiles by the output's column tiles; each block scans the counts (one
//   warp, shuffles) for the expert its row tile belongs to and exits where
//   the tile lies past the last: no host synchronisation;
// - row tiles run fastest in the grid, so the row tiles of one expert and
//   one column block run together and the L2 serves most weight reads;
// - a 2-stage cp.async ring of 128 x 64 rows (gathered by token in the
//   gate/up pass) and 128 x 64 weight rows feeds bf16 tensor-core products
//   (ldmatrix, mma.sync m16n8k16, float32 accumulation), 16 warps of
//   32 x 32 outputs; a row tile of 128 reads each weight tile about 3
//   times at ~300 rows an expert (the ring's depth, the row tile and the
//   stages were chosen by timing on an H100 at the dream's shapes);
// - gate and up keep two float32 accumulators; silu(gate) * up is formed
//   in float32 and rounded to bf16 once; the down pass writes each slot's
//   row to its place in token order.
// Tile shapes are fixed (no tuning at set-up). Inner sizes (hidden, expert
// width) must be multiples of BK, output widths of 8 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // token-slots a row tile (moe_kernel.BM)
constexpr int BN = 128;        // output columns a tile
constexpr int BK = 64;         // depth a stage
constexpr int STAGES = 2;
constexpr int THREADS = 512;   // 16 warps: 4 (rows) x 4 (columns) of 32 x 32
constexpr int LDS = BK + 8;    // a staged row's pitch (144 bytes: 16-byte
                               // chunks, rows off each other's banks)
constexpr int LDC = BN + 4;    // the epilogue's float row pitch

constexpr int GATE_UP_SMEM = STAGES * (BM + 2 * BN) * LDS * 2;   // 110,592
constexpr int DOWN_SMEM = STAGES * (BM + BN) * LDS * 2;          //  73,728
static_assert(BM * LDC * 4 <= DOWN_SMEM, "the epilogue reuses the ring");
static_assert(THREADS == 4 * BM && BN == 128, "warps of 32 x 32 outputs");
static_assert(BM * BK / 8 >= THREADS, "a stage's A rows take every thread");
static_assert(BM * BN / 8 % THREADS == 0, "the epilogue's chunks");

struct Tile {
  int e;       // the expert (E where the tile lies past the last)
  int first;   // the expert's first sorted place
  int r0;      // the tile's first row within the expert
  int rows;    // rows of the tile that hold slots
};

// The row tile blockIdx.x of the table the counts give: each expert's
// ceil(count / BM) tiles, experts in order. One warp scans 32 experts at a
// time (tiles and places, inclusive, by shuffles).
__device__ Tile find_tile(const int* __restrict__ counts, int E) {
  __shared__ Tile t;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, pid = blockIdx.x;
    int tiles_before = 0, places_before = 0;
    bool found = false;
    for (int base = 0; base < E && !found; base += 32) {
      const int e = base + lane;
      const int c = e < E ? counts[e] : 0;
      const int nt = (c + BM - 1) / BM;
      int st = nt, sc = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, st, o);
        const int b = __shfl_up_sync(0xffffffffu, sc, o);
        if (lane >= o) {
          st += a;
          sc += b;
        }
      }
      const unsigned hit =
          __ballot_sync(0xffffffffu, e < E && tiles_before + st > pid);
      if (hit) {
        if (lane == __ffs(hit) - 1) {
          t.e = e;
          t.first = places_before + sc - c;
          t.r0 = (pid - (tiles_before + st - nt)) * BM;
          t.rows = min(BM, c - t.r0);
        }
        found = true;
      } else {
        tiles_before += __shfl_sync(0xffffffffu, st, 31);
        places_before += __shfl_sync(0xffffffffu, sc, 31);
      }
    }
    if (!found && lane == 0) t.e = E;
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row) x b (16 x 8, col), bf16 in, float32 accumulation
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a warp's 32 x 32 outputs of one product: 2 (rows of 16) x 4 (columns of
// 8) mma tiles of 4 floats a lane
using Acc = float[2][4][4];

// rows x BK of A (row r from a_row[r]) and of NB weight matrices (BN rows
// from column n0, clamped to the last) into one stage of the ring
template <int NB>
__device__ __forceinline__ void stage_load(
    bf16* st, const bf16* const* a_row, const bf16* const (&w)[NB],
    int n0, int N, int K, int k0) {
  constexpr int CPR = BK / 8;             // 16-byte chunks a row
  const int tid = threadIdx.x, c = (tid % CPR) * 8;
#pragma unroll
  for (int i = 0; i < BM * CPR / THREADS; ++i) {
    const int r = tid / CPR + i * (THREADS / CPR);
    cp16(st + r * LDS + c, a_row[r] + k0 + c);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    bf16* sb = st + (BM + b * BN) * LDS;
#pragma unroll
    for (int i = 0; i < BN * CPR / THREADS; ++i) {
      const int r = tid / CPR + i * (THREADS / CPR);
      const int n = min(n0 + r, N - 1);
      cp16(sb + r * LDS + c, w[b] + static_cast<size_t>(n) * K + k0 + c);
    }
  }
}

// acc[b] += A(rows) x W_b(n0..n0+BN)^T over K, through the ring
template <int NB>
__device__ __forceinline__ void grouped_mainloop(
    bf16* ring, const bf16* const* a_row, const bf16* const (&w)[NB], int n0,
    int N, int K, Acc (&acc)[NB]) {
  constexpr int STAGE = (BM + NB * BN) * LDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[b][i][j][u] = 0.0f;
  // each lane's row address in the ldmatrix loads: A by rows of 16 and
  // k halves; W by pairs of 8 columns and k halves
  const int a_off = (wm * 32 + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int w_off =
      (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) stage_load<NB>(ring + s * STAGE, a_row, w, n0, N, K, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      stage_load<NB>(ring + (nk % STAGES) * STAGE, a_row, w, n0, N, K,
                     nk * BK);
    cp_commit();
    const bf16* st = ring + (kt % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(a[i], st + a_off + i * 16 * LDS + kk);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const bf16* sb = st + (BM + b * BN) * LDS + w_off + kk;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          unsigned f[4];
          ldsm_x4(f, sb + jp * 16 * LDS);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816(acc[b][i][2 * jp], a[i], f[0], f[1]);
            mma16816(acc[b][i][2 * jp + 1], a[i], f[2], f[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free for the epilogue
}

// the BM x BN float tile C (pitch LDC) rounded to bf16, row r written to
// out + dst[r] * ld + n0, rows below `rows` and columns below N
__device__ __forceinline__ void store_rows(const float* C, bf16* out,
                                           const int64_t* dst, int rows,
                                           int n0, int N, int ld) {
#pragma unroll
  for (int q = 0; q < BM * BN / 8 / THREADS; ++q) {
    const int chunk = threadIdx.x + q * THREADS;
    const int r = chunk / (BN / 8), col = (chunk % (BN / 8)) * 8;
    if (r >= rows || n0 + col >= N) continue;
    const float* src = C + r * LDC + col;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16(src[u]);
    *reinterpret_cast<uint4*>(out + dst[r] * ld + n0 + col) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// a warp's tile into the float tile C (pitch LDC)
__device__ __forceinline__ void store_acc(float* C, const Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp >> 2) * 32 + (lane >> 2);
  const int c0 = (warp & 3) * 32 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* p = C + (r0 + i * 16) * LDC + c0 + j * 8;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * LDC) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

// h[place] = silu(x[token] Wg[e]^T) * (x[token] Wu[e]^T) for each sorted
// place of expert e's slots; x (N, H), wg and wu (E, I, H), h (slots, I)
__global__ void __launch_bounds__(THREADS) moe_gate_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wg,
    const bf16* __restrict__ wu, bf16* __restrict__ h,
    const int64_t* __restrict__ order, const int* __restrict__ counts, int E,
    int k_top, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ const bf16* a_row[BM];
  __shared__ int64_t dst[BM];
  const Tile t = find_tile(counts, E);
  if (t.e >= E) return;
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int64_t place = t.first + t.r0 + min(r, t.rows - 1);
    a_row[r] = x + (order[place] / k_top) * H;
    dst[r] = place;
  }
  __syncthreads();
  const int n0 = blockIdx.y * BN;
  const size_t off = static_cast<size_t>(t.e) * I * H;
  const bf16* const w[2] = {wg + off, wu + off};
  Acc acc[2];
  grouped_mainloop<2>(reinterpret_cast<bf16*>(smem), a_row, w, n0, I, H, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float g = acc[0][i][j][u];
        acc[0][i][j][u] = g / (1.0f + expf(-g)) * acc[1][i][j][u];
      }
  float* C = reinterpret_cast<float*>(smem);
  store_acc(C, acc[0]);
  store_rows(C, h, dst, t.rows, n0, I, I);
}

// y[slot] = h[place] Wd[e]^T for each sorted place of expert e's slots;
// h (slots, I), wd (E, H, I), y (slots, H) in slot order
__global__ void __launch_bounds__(THREADS) moe_down_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wd,
    bf16* __restrict__ y, const int64_t* __restrict__ order,
    const int* __restrict__ counts, int E, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ const bf16* a_row[BM];
  __shared__ int64_t dst[BM];
  const Tile t = find_tile(counts, E);
  if (t.e >= E) return;
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int64_t place = t.first + t.r0 + min(r, t.rows - 1);
    a_row[r] = h + place * I;
    dst[r] = order[place];
  }
  __syncthreads();
  const int n0 = blockIdx.y * BN;
  const bf16* const w[1] = {wd + static_cast<size_t>(t.e) * H * I};
  Acc acc[1];
  grouped_mainloop<1>(reinterpret_cast<bf16*>(smem), a_row, w, n0, H, I, acc);
  float* C = reinterpret_cast<float*>(smem);
  store_acc(C, acc[0]);
  store_rows(C, y, dst, t.rows, n0, H, H);
}

}  // namespace

// The ring's dynamic shared memory above 48 KB, once a device, before the
// first launch (and before any graph capture); a cudaError, 0 on success.
extern "C" int moe_experts_init() {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GATE_UP_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(moe_down_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              DOWN_SMEM);
}

// (BM, BK): the row tile and the depth the inner sizes must divide by
extern "C" void moe_experts_tiles(int* bm, int* bk) {
  *bm = BM;
  *bk = BK;
}

// Both GEMM passes on `stream`: x (N, H) bf16; wg, wu (E, I, H); wd (E, H,
// I); h (slots, I) and y (slots, H) scratch and output; order (slots,)
// int64 the flat slot of each sorted place; counts (E,) int32. Returns the
// first launch's cudaError, 0 on success.
extern "C" int moe_experts_launch(const void* x, const void* wg,
                                  const void* wu, const void* wd, void* h,
                                  void* y, const void* order,
                                  const void* counts, int E, int k_top,
                                  int slots, int H, int I, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (slots + BM - 1) / BM + E;
  const auto* o = static_cast<const int64_t*>(order);
  const auto* c = static_cast<const int*>(counts);
  moe_gate_up_kernel<<<dim3(tiles, (I + BN - 1) / BN), THREADS, GATE_UP_SMEM,
                       s>>>(static_cast<const bf16*>(x),
                            static_cast<const bf16*>(wg),
                            static_cast<const bf16*>(wu),
                            static_cast<bf16*>(h), o, c, E, k_top, H, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<<<dim3(tiles, (H + BN - 1) / BN), THREADS, DOWN_SMEM, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd),
      static_cast<bf16*>(y), o, c, E, H, I);
  return cudaGetLastError();
}
