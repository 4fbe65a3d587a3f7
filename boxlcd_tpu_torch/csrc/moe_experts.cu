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
// ~300 rows an expert it sits on the ridge point, so the tensor cores and
// the loads have to run at once, and each weight tile must be read from
// device memory about once. The design (sm_90a):
// - tensor cores through wgmma, bf16 operands from 128-byte-swizzled shared
//   memory, float32 accumulators in registers. The weights are the wide
//   side (M: 64 weight rows a warpgroup and product) and the tokens the
//   narrow one (N: any multiple of 8 up to TN), so a tile's token rows
//   follow its expert's count;
// - tiles sized to each expert's rows: an expert of c rows takes
//   ceil(c / TN) token tiles of equal width w (ceil(c / tiles) rounded up
//   to 8), the last one the rest, rounded up to 8; wgmma's N is the
//   tile's rows rounded up to 8 (one instantiation for each), so ~300
//   rows an expert cover 304 (3 x 104) where fixed 128-row tiles cover
//   384. Each weight tile is read by its expert's token tiles, which run
//   side by side, so the L2 serves all but the first read;
// - warp-specialised blocks of 384 threads: two consumer warpgroups
//   (setmaxnreg 224) and one producer warpgroup (setmaxnreg 56) around a
//   4-stage ring of 48 KB (256 weight rows and TN token rows of 64 deep),
//   with mbarrier full/empty pairs. The weights come by TMA (2-D boxes of
//   the (E*I, H) and (E*H, I) matrices, the tensor maps built on the host
//   and passed as __grid_constant__ parameters). The gate/up pass's
//   producer warpgroup gathers the x rows by token with cp.async into the
//   same swizzled layout (x is 13 MB and stays in L2; no permuted copy of
//   x); the down pass's rows of h, an expert's places being contiguous,
//   come by TMA in boxes of 8 rows (rows past the expert's count are loaded
//   and never stored);
// - persistent: one block an SM walks the tile list (expert, column block,
//   token tile; token tiles fastest) that each warp derives from the
//   counts on the device (shuffles over 32 experts at a time): no host
//   synchronisation, and a tile's epilogue overlaps the next tile's loads;
// - the epilogue: gate/up keeps two float32 accumulators (a warpgroup's 64
//   gate rows and the same 64 up rows), forms silu(gate) * up in float32
//   and rounds to bf16 once; down holds 128 weight rows a warpgroup (two
//   products) and rounds each output to bf16. Both stage the tile through
//   swizzled shared memory (transposing it to token rows) and write 16-byte
//   chunks: h at its sorted place, y at each slot's place in token order.
// Tile shapes are fixed (no tuning at set-up). The expert width must be a
// multiple of 128 and the hidden size of 256 (the wrapper checks).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TN = 128;       // most token rows a tile (moe_kernel.TN)
constexpr int BK = 64;        // depth a stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int LAG = 1;        // stages a gathering thread keeps in flight
                              // before it signals (at most STAGES - 2)
constexpr int THREADS = 384;  // consumer warpgroups 0-1, the producer 2
constexpr int GU_COLS = 128;  // h columns a gate/up tile (64 a warpgroup)
constexpr int DN_COLS = 256;  // y columns a down tile (128 a warpgroup)
constexpr int W_BYTES = 256 * BK * 2;    // a stage's weight rows
constexpr int T_BYTES = TN * BK * 2;     // a stage's token rows
constexpr int STAGE_BYTES = W_BYTES + T_BYTES;
constexpr int OUT_BYTES = TN * 64 * 2;   // a consumer warpgroup's staging
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * OUT_BYTES +
                     2 * STAGES * 8;
static_assert(SMEM <= 232448, "one block an SM");
static_assert(LAG <= STAGES - 2, "consumers free a stage one stage late");

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// waits for the phase of `bar` with this parity to complete; traps (the
// launch fails) after ~2^26 polls rather than hang the card on a fault
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// a 2-D box of `map` at (c0 columns, c1 rows) into shared memory, its bytes
// reported to `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the thread's shared-memory writes (generic proxy) before wgmma reads
// them (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the wgmma descriptor of a K-major operand in 128-byte-swizzled shared
// memory at `addr` (1024-byte atoms of 8 rows): leading offset unused (1),
// stride 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x N, float32) += A (64 x 16) B (16 x N)^T, bf16, both K-major
// through their descriptors; d is its first N / 2 (every N shares one
// array: ptxas keeps one set of accumulator registers); `acc` 0
// overwrites d. A warpgroup's lane holds d[4j + 2h + q] at row
// 16 * warp + lane / 4 + 8h and column 8j + 2 (lane % 4) + q.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[TN / 2], uint64_t a,
                                      uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<40>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<56>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27"
      "}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<72>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<88>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43"
      "}, %44, %45, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<104>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<120>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, %60, %61, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[TN / 2], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// -- the tile list -------------------------------------------------------

// an expert's token-tile width: ceil(c / tiles) rounded up to 8, with
// ceil(c / TN) tiles (moe_kernel.tile_rows)
__device__ __forceinline__ int tile_width(int c) {
  if (c <= 0) return 0;
  const int nt = (c + TN - 1) / TN;
  return ((c + nt - 1) / nt + 7) & ~7;
}

struct Tile {
  int e;       // the expert
  int col;     // the tile's first output column
  int first;   // the expert's first sorted place
  int r0;      // the tile's first row within the expert
  int rows;    // rows of the tile that hold slots (n: rounded up to 8)
};

// The tile t of the list the counts give: experts in order, each expert's
// column blocks (`blocks` of `cols` columns), each block's token tiles. A
// warp's lanes all return the same; false where t lies past the last.
__device__ __forceinline__ bool find_tile(const int* __restrict__ counts,
                                          int E, int blocks, int cols, int t,
                                          Tile& out) {
  const int lane = threadIdx.x & 31;
  int tiles_before = 0, places_before = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int c = e < E ? counts[e] : 0;
    const int w = tile_width(c);
    const int nt = w ? (c + w - 1) / w : 0;
    int st = nt * blocks, sc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, st, o);
      const int b = __shfl_up_sync(0xffffffffu, sc, o);
      if (lane >= o) {
        st += a;
        sc += b;
      }
    }
    const unsigned hit =
        __ballot_sync(0xffffffffu, e < E && tiles_before + st > t);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int ce = __shfl_sync(0xffffffffu, c, src);
      const int we = __shfl_sync(0xffffffffu, w, src);
      const int ne = __shfl_sync(0xffffffffu, nt, src);
      const int rem = t - tiles_before - __shfl_sync(0xffffffffu, st, src) +
                      ne * blocks;
      out.e = base + src;
      out.col = rem / ne * cols;
      out.first = places_before + __shfl_sync(0xffffffffu, sc, src) - ce;
      out.r0 = rem % ne * we;
      out.rows = min(we, ce - out.r0);
      return true;
    }
    tiles_before += __shfl_sync(0xffffffffu, st, 31);
    places_before += __shfl_sync(0xffffffffu, sc, 31);
  }
  return false;
}

// -- shared memory ---------------------------------------------------------

struct Smem {
  uint32_t base;   // the ring, 1024-byte aligned
  unsigned char* gen;
  __device__ uint32_t weights(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t tokens(int s) const {
    return base + s * STAGE_BYTES + W_BYTES;
  }
  __device__ unsigned char* out(int wg) const {
    return gen + STAGES * STAGE_BYTES + wg * OUT_BYTES;
  }
  __device__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + 2 * OUT_BYTES + s * 8;
  }
  __device__ uint32_t empty(int s) const { return full(STAGES + s); }
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  const uint32_t pad = (1024 - (a & 1023)) & 1023;
  return Smem{a + pad, raw + pad};
}

// barriers: full[s] takes `full_count` arrivals and the TMA bytes, empty[s]
// one arrival from each of the 8 consumer warps
__device__ __forceinline__ void init_barriers(const Smem& sm, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), full_count);
      mbar_init(sm.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer waits until the consumers have released every stage
__device__ __forceinline__ void producer_tail(const Smem& sm, int it) {
  for (int j = it; j < it + STAGES; ++j)
    mbar_wait(sm.empty(j % STAGES), ((j / STAGES) & 1) ^ 1);
}

// -- the consumers ---------------------------------------------------------

// a consumer warpgroup's products of one tile over K / BK stages from
// stage counter `it`: acc[p] (64 weight rows x N tokens) over weight rows
// 128p + 64 wg of the stage's 256
template <int N>
__device__ __forceinline__ void mainloop(const Smem& sm, int wg, int it,
                                         int KT, float (&acc)[2][TN / 2]) {
  const int lane = threadIdx.x & 31;
  for (int kt = 0; kt < KT; ++kt) {
    const int j = it + kt, s = j % STAGES;
    mbar_wait(sm.full(s), (j / STAGES) & 1);
    const uint64_t a0 = sw128_desc(sm.weights(s) + wg * 8192);
    const uint64_t a1 = sw128_desc(sm.weights(s) + 16384 + wg * 8192);
    const uint64_t b = sw128_desc(sm.tokens(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int more = kt | kk;
      wgmma<N>(acc[0], a0 + 2 * kk, b + 2 * kk, more);
      wgmma<N>(acc[1], a1 + 2 * kk, b + 2 * kk, more);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(sm.empty((j - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  if (lane == 0) mbar_arrive(sm.empty((it + KT - 1) % STAGES));
}

// the warpgroup's 64 x N tile v into its staging as bf16 token rows of 64
// columns (16-byte chunks swizzled by the row), then its rows below `rows`
// out: row r's 128 bytes to dst + (order ? order[r] : r) * ld
template <int N>
__device__ __forceinline__ void store_tile(unsigned char* out,
                                           const bf16 (&v)[N / 2], int rows,
                                           bf16* dst, int64_t ld,
                                           const int64_t* order) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int wg = threadIdx.x >> 7;
  // v[i] is (column 16 warp + lane / 4 + 8 h, token 8 (i / 4) + 2 b + q)
  // with h = i / 2 % 2, q = i % 2, b = lane % 4: its chunk (column / 8) ^
  // (token % 8) is 2 (warp ^ b) + (h ^ q), so each store is one base
  // register and a constant offset (nothing a thread keeps a store)
  const int b = lane & 3;
  unsigned char* base = out + b * 256 + ((warp ^ b) << 5) + (lane >> 2) * 2;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int q = i & 1, h = (i >> 1) & 1;
    *reinterpret_cast<bf16*>(base + (i >> 2) * 1024 + q * 128 +
                             ((h ^ q) << 4)) = v[i];
  }
  bar_sync(1 + wg, 128);
  for (int idx = t; idx < rows * 8; idx += 128) {
    const int r = idx >> 3, c = idx & 7;
    const int64_t row = order ? order[r] : r;
    *reinterpret_cast<uint4*>(dst + row * ld + c * 8) =
        *reinterpret_cast<const uint4*>(out + r * 128 + ((c ^ (r & 7)) << 4));
  }
  bar_sync(1 + wg, 128);
}

struct GateUpOut {
  bf16* h;
  int I;
};
struct DownOut {
  bf16* y;
  const int64_t* order;
  int H;
};

template <int N>
__device__ __forceinline__ void consume(const Smem& sm, int wg, int it,
                                        int KT, const Tile& ti,
                                        const GateUpOut& o,
                                        float (&acc)[2][TN / 2]) {
  mainloop<N>(sm, wg, it, KT, acc);
  bf16 v[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float g = acc[0][i];
    v[i] = __float2bfloat16(g / (1.0f + expf(-g)) * acc[1][i]);
  }
  store_tile<N>(sm.out(wg), v, ti.rows,
                o.h + static_cast<int64_t>(ti.first + ti.r0) * o.I + ti.col +
                    wg * 64,
                o.I, nullptr);
}

template <int N>
__device__ __forceinline__ void consume(const Smem& sm, int wg, int it,
                                        int KT, const Tile& ti,
                                        const DownOut& o,
                                        float (&acc)[2][TN / 2]) {
  mainloop<N>(sm, wg, it, KT, acc);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    bf16 v[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) v[i] = __float2bfloat16(acc[p][i]);
    store_tile<N>(sm.out(wg), v, ti.rows, o.y + ti.col + p * 128 + wg * 64,
                  o.H, o.order + ti.first + ti.r0);
  }
}

// the consumer warpgroups' walk over the tile list: wgmma's N is the
// tile's rows rounded up to 8
template <class Out>
__device__ __forceinline__ void consumer(const Smem& sm,
                                         const int* __restrict__ counts,
                                         int E, int blocks, int cols, int KT,
                                         const Out& o) {
  setmaxnreg_inc<224>();
  const int wg = threadIdx.x >> 7;
  float acc[2][TN / 2];   // one set of accumulators for every N
  int it = 0;
  Tile ti;
  for (int t = blockIdx.x; find_tile(counts, E, blocks, cols, t, ti);
       t += gridDim.x, it += KT) {
    switch ((ti.rows + 7) >> 3) {
#define MOE_N(n)                                 \
  case n:                                        \
    consume<8 * n>(sm, wg, it, KT, ti, o, acc);  \
    break;
      MOE_N(1) MOE_N(2) MOE_N(3) MOE_N(4) MOE_N(5) MOE_N(6) MOE_N(7) MOE_N(8)
      MOE_N(9) MOE_N(10) MOE_N(11) MOE_N(12) MOE_N(13) MOE_N(14) MOE_N(15)
      MOE_N(16)
#undef MOE_N
    }
  }
}

// -- the kernels -------------------------------------------------------------

// h[place] = silu(x[token] Wg[e]^T) * (x[token] Wu[e]^T) for each sorted
// place of expert e's slots; x (N, H), wg and wu (E, I, H) through their
// tensor maps (rows e * I + column), h (slots, I)
__global__ void __launch_bounds__(THREADS, 1) moe_gate_up_kernel(
    const __grid_constant__ CUtensorMap map_g,
    const __grid_constant__ CUtensorMap map_u, const bf16* __restrict__ x,
    bf16* __restrict__ h, const int64_t* __restrict__ order,
    const int* __restrict__ counts, int E, int k_top, int H, int I) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  init_barriers(sm, 128 + 1);   // each gathering thread, and the TMA's
  const int blocks = I / GU_COLS, KT = H / BK;
  if (threadIdx.x >= 256) {
    // the producer: the weights by TMA (thread 0), the x rows of the tile's
    // tokens by cp.async (16-byte chunk c of rows rb + 16 i a thread), each
    // thread signalling a stage once its own copies of it have landed
    setmaxnreg_dec<56>();
    const int pt = threadIdx.x - 256, c = pt & 7, rb = pt >> 3;
    int it = 0;
    Tile ti;
    for (int t = blockIdx.x; find_tile(counts, E, blocks, GU_COLS, t, ti);
         t += gridDim.x) {
      const int n = (ti.rows + 7) & ~7;
      const bf16* src[TN / 16];
#pragma unroll
      for (int i = 0; i < TN / 16; ++i) {
        const int r = min(rb + 16 * i, ti.rows - 1);
        src[i] = x + order[ti.first + ti.r0 + r] / k_top * H + c * 8;
      }
      const int wrow = ti.e * I + ti.col;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect(sm.full(s), W_BYTES);
          tma_load(sm.weights(s), &map_g, kt * BK, wrow, sm.full(s));
          tma_load(sm.weights(s) + W_BYTES / 2, &map_u, kt * BK, wrow,
                   sm.full(s));
        }
        const uint32_t dst = sm.tokens(s);
#pragma unroll
        for (int i = 0; i < TN / 16; ++i) {
          const int r = rb + 16 * i;
          if (r < n)
            cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), src[i] + kt * BK);
        }
        cp_commit();
        if (it >= LAG) {
          cp_wait<LAG>();
          fence_async_smem();
          mbar_arrive(sm.full((it - LAG) % STAGES));
        }
      }
    }
    cp_wait<0>();
    fence_async_smem();
    for (int j = it < LAG ? 0 : it - LAG; j < it; ++j)
      mbar_arrive(sm.full(j % STAGES));
    producer_tail(sm, it);
  } else {
    consumer(sm, counts, E, blocks, GU_COLS, KT, GateUpOut{h, I});
  }
}

// y[slot] = h[place] Wd[e]^T for each sorted place of expert e's slots; h
// (slots, I) and wd (E, H, I) through their tensor maps, y (slots, H) in
// slot order
__global__ void __launch_bounds__(THREADS, 1) moe_down_kernel(
    const __grid_constant__ CUtensorMap map_d,
    const __grid_constant__ CUtensorMap map_h, bf16* __restrict__ y,
    const int64_t* __restrict__ order, const int* __restrict__ counts, int E,
    int H, int I) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  init_barriers(sm, 1);   // the TMA's
  const int blocks = H / DN_COLS, KT = I / BK;
  if (threadIdx.x >= 256) {
    // the producer's first warp: 256 weight rows in one box (lane 0), the
    // tile's h rows in boxes of 8 (a lane each)
    setmaxnreg_dec<56>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x & 31;
    int it = 0;
    Tile ti;
    for (int t = blockIdx.x; find_tile(counts, E, blocks, DN_COLS, t, ti);
         t += gridDim.x) {
      const int pieces = (ti.rows + 7) >> 3;
      const int wrow = ti.e * H + ti.col, hrow = ti.first + ti.r0 + 8 * lane;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect(sm.full(s), W_BYTES + pieces * 1024);
          tma_load(sm.weights(s), &map_d, kt * BK, wrow, sm.full(s));
        }
        __syncwarp();
        if (lane < pieces)
          tma_load(sm.tokens(s) + lane * 1024, &map_h, kt * BK, hrow,
                   sm.full(s));
      }
    }
    producer_tail(sm, it);
  } else {
    consumer(sm, counts, E, blocks, DN_COLS, KT, DownOut{y, order, H});
  }
}

// -- the host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major bf16 matrix (rows, cols), boxes of 64
// columns (128 bytes, swizzled) by box_rows
int encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
           uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return -1;
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {cols * 2};
  const cuuint32_t box[2] = {BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dim, stride, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

}  // namespace

// The ring's dynamic shared memory above 48 KB, once a device, before the
// first launch (and before any graph capture); a cudaError, 0 on success.
extern "C" int moe_experts_init() {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      moe_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

// (TN, and the multiples the expert width and the hidden size must be):
// the most token rows a tile, the gate/up and down tiles' columns
extern "C" void moe_experts_tiles(int* tn, int* i_mult, int* h_mult) {
  *tn = TN;
  *i_mult = GU_COLS;
  *h_mult = DN_COLS;
}

// Both GEMM passes on `stream`: x (N, H) bf16; wg, wu (E, I, H); wd (E, H,
// I); h (slots, I) and y (slots, H) scratch and output; order (slots,)
// int64 the flat slot of each sorted place; counts (E,) int32. Returns 0
// on success, a cudaError of a launch, or -1000 - a CUresult of a tensor
// map (-1: no encoder).
extern "C" int moe_experts_launch(const void* x, const void* wg,
                                  const void* wu, const void* wd, void* h,
                                  void* y, const void* order,
                                  const void* counts, int E, int k_top,
                                  int slots, int H, int I, void* stream) {
  if (slots <= 0) return 0;
  CUtensorMap map_g, map_u, map_d, map_h;
  int err = encode(&map_g, wg, static_cast<uint64_t>(E) * I, H, 128);
  if (!err) err = encode(&map_u, wu, static_cast<uint64_t>(E) * I, H, 128);
  if (!err) err = encode(&map_d, wd, static_cast<uint64_t>(E) * H, I, 256);
  if (!err) err = encode(&map_h, h, slots, I, 8);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the most tiles any routing can give: ceil(slots / TN) + E token tiles
  // a column block
  const int rows_most = (slots + TN - 1) / TN + E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* c = static_cast<const int*>(counts);
  moe_gate_up_kernel<<<std::min(sms, rows_most * (I / GU_COLS)), THREADS, SMEM,
                       s>>>(map_g, map_u, static_cast<const bf16*>(x),
                            static_cast<bf16*>(h), o, c, E, k_top, H, I);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_down_kernel<<<std::min(sms, rows_most * (H / DN_COLS)), THREADS, SMEM, s>>>(
      map_d, map_h, static_cast<bf16*>(y), o, c, E, H, I);
  return cudaGetLastError();
}
