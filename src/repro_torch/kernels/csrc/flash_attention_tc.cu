// Forward flash attention for bfloat16 q, k, v on Hopper, over the model's
// (B, S, H, D) layout.
//
// Replaces the bfloat16 route of the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (float32 inputs keep
// the CUDA-core kernel of flash_attention.cu). It computes what that kernel
// computes, block by block:
//
//   s     = (q . k) * sm_scale, masked to -1e30 (causal k <= q; window
//           k > q - window); keys past S_k score -inf and have value 0
//   m_new = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(p);  acc = alpha * acc + p v
//   out   = acc * (1 / max(l, 1e-30)), rounded once to bfloat16
//
// with m starting at -1e30 and l, acc at 0, so a row with no allowed key
// averages every value. The TPU kernel's two products are one bf16 pass on
// the MXU at default precision; here they are bf16 tensor-core products
// with float32 accumulators: q.k^T is exact per product and differs only in
// summation order, and p is rounded to bf16 before p.v as the MXU rounds
// it. The softmax runs in float32 in registers, in the log2 domain (exp2 of
// scores prescaled by sm_scale * log2(e)); the output is acc times one
// reciprocal of max(l, 1e-30) a row.
//
// What bounds it on the H100: at the GQA prefill shapes (4, 1024, 32-96
// heads over 8, D 128, causal) it does 4*B*H*D*sum(allowed pairs) = 34-103
// GFLOP, 35-104 us on the bf16 tensor cores' 989 TFLOP/s, against 25-67 MB
// moved (8-20 us at 3.35 TB/s): it is bound by operations. The kernel
// before this one (mma.sync, cp.async from every thread, one double buffer,
// four warps taking turns at loads, products and softmax) reached 0.16-0.20
// of that bound. What this design does about it:
//   * products are wgmma.mma_async m64nNk16 (bf16 in, float32 out), the only
//     way to the tensor cores' full rate: s = q.k^T takes q and k from
//     shared memory; o += p.v takes p from registers (the float32 score
//     accumulators, rounded to bf16, are in the A-fragment layout) and v
//     from shared memory as it lies, through the transposed-B form;
//   * loads are TMA (cp.async.bulk.tensor) into a ring of K/V stages, with
//     one mbarrier pair (full, empty) a stage and a tile. The tensor maps
//     describe (B, S, H, D) as a 4-D tensor with S its own dimension, so a
//     box never reads the next batch's rows, and TMA's zero fill takes the
//     place of masked loads: keys past S_k, query rows past S_q, columns
//     past D in a padded bucket. Tiles are kept as 64-column (128-byte)
//     chunks in the 128-byte swizzle that the wgmma descriptors name;
//   * warp specialisation: a block is one producer warpgroup, of which one
//     thread issues every TMA load, and NC consumer warpgroups of 64 query
//     rows each (setmaxnreg gives the producer 24 registers and two
//     consumers 240). A consumer overlaps the softmax of key tile j with
//     the p.v product of tile j-1: issue s_j, rescale o, issue
//     o += p_{j-1} v_{j-1}, wait for s_j, softmax, wait for p.v. At D 128
//     two consumers on the same key tiles also take turns at issuing their
//     products (two named barriers), so one's softmax runs while the
//     other's products hold the tensor cores;
//   * the softmax has two bodies, picked by one branch a tile: tiles that
//     cross the causal diagonal, the window edge or S_k take index masks
//     (one compare against a per-row bound a column); the others take the
//     row max of the raw scores and one FFMA (s * scale - m) before each
//     exp2. Masks written inside one body were if-converted, so every tile
//     paid for them; and the branch's join keeps the compiler from hoisting
//     the wait for p.v over the exponentials;
//   * tiles: 128 query rows (two consumers) x 128 keys at D <= 128 (D = 64
//     keeps three K/V stages), x 64 keys at D = 256: 112, 160 and 192 KB of
//     shared memory, one block an SM. Where blocks of 128 rows would not
//     fill the card's 132 SMs, the wrapper picks by shape the one-consumer
//     instance of 64 rows;
//   * the output is rounded to bf16 in the consumers, written into the
//     block's own q tile in shared memory and stored by TMA, which clips
//     rows past S_q and columns past D;
//   * blocks are launched heaviest first: the linear block index walks the
//     query tiles from the last (most key tiles under a causal mask) to the
//     first across every head, so the grid's tail is short tiles; key tiles
//     wholly above the causal diagonal or outside the window are skipped
//     (per consumer), and every sum is in a fixed order with no atomics, so
//     the output is the same bit for bit run to run.
// TMA needs 16-byte aligned bases and row strides: the wrapper copies
// inputs with D % 8 != 0 or an unaligned base into padded aligned buffers
// first. A wait that never completes traps rather than hanging the card.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so nothing new is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 64;          // bf16 columns in a 128-byte swizzle row
constexpr uint32_t kChunkRowBytes = 128;

// One instance: DP the padded head width, NC the consumer warpgroups.
template <int DP_, int NC_>
struct Cfg {
  static constexpr int DP = DP_, NC = NC_;
  static constexpr int BQ = 64 * NC;              // query rows a work tile
  static constexpr int BK = DP == 256 ? 64 : 128; // keys a K/V tile
  static constexpr int STAGES = DP == 64 ? 3 : 2; // K/V ring depth
  static constexpr int CH = DP / kChunk;          // chunks a row
  static constexpr int THREADS = 128 * (NC + 1);
  // two consumers take turns at their products (ping-pong): measured
  // faster at D 128, slower at 64 and 256
  static constexpr bool PINGPONG = NC == 2 && DP == 128;
  static constexpr uint32_t QW_BYTES = 64 * DP * 2;  // one consumer's q
  static constexpr uint32_t Q_BYTES = NC * QW_BYTES;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr uint32_t TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // q full a consumer, K and V full / empty a stage
  static constexpr int BARRIERS = NC + 4 * STAGES;
  // + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr uint32_t SMEM = TILE_BYTES + 1024 + 8 * BARRIERS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();  // seconds: a lost arrival, not work
  }
}

// -------------------------------------------------------------------- TMA
// One box of the 4-D map (D, H, S, B) at {col, head, row, batch} into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// K-major tiles (q, k) use the stride between 8-row groups (1024 bytes);
// the N-major v tile also the leading offset between 64-column chunks.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that releases them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

// d (64 x 64, float32) = [d +] a (64 x 16, smem) . b (64 x 16, smem)^T,
// both K-major; scale_d = 0 overwrites d
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, float32) = [d +] a (64 x 16, smem) . b (128 x 16, smem)^T,
// both K-major; scale_d = 0 overwrites d
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, float32) = [d +] a (64 x 16, registers) . b (16 x 64,
// smem, N-major: the transposed-B form)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 128, float32) = [d +] a (64 x 16, registers) . b (16 x 128,
// smem, N-major: the transposed-B form)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 256, float32) = [d +] a (64 x 16, registers) . b (16 x 256,
// smem, N-major: the transposed-B form)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keys [kb, ke) that hold every allowed key of query rows [r0, r1]; the
// whole of [0, S_k) when row r1 has none (it averages every value).
__device__ __forceinline__ void key_range(int r0, int r1, int S_k, int causal,
                                          int window, int& kb, int& ke) {
  kb = 0;
  ke = S_k;
  if (window > 0 && (long long)r1 - window >= (long long)S_k - 1) return;
  if (causal) ke = min(S_k, r1 + 1);
  if (window > 0) kb = max(0, r0 - window + 1);
}

// s = q . k^T over DP / 16 steps of 16 columns, as one wgmma group
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[C::BK / 2], uint64_t dq,
                                         uint32_t k_tile) {
  const uint64_t dk = make_desc(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint32_t chunk = kk / 4, col = (kk % 4) * 32;
    wgmma_ss<C::BK>(s, dq + ((chunk * 64 * kChunkRowBytes + col) >> 4),
                    dk + ((chunk * C::BK * kChunkRowBytes + col) >> 4),
                    kk > 0);
  }
  wgmma_commit();
}

// o += p . v over BK / 16 steps of 16 keys, as one wgmma group; v is
// N-major: 64-column chunks BK * 128 bytes apart, 8-key groups 1024
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::DP / 2],
                                         const uint32_t (&p)[C::BK / 4],
                                         uint32_t v_tile) {
  const uint64_t dv = make_desc(v_tile, C::BK * kChunkRowBytes, 1024);
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs<C::DP>(o, a, dv + ((kk * 16 * kChunkRowBytes) >> 4), 1);
  }
  wgmma_commit();
}

// The scores of key tile kt (this thread's rows qi0, qi0 + 8; columns
// 8j + 2 t4 + {0, 1}) to probabilities in place; m and l updated, alpha the
// factors that rescale o. EDGE: the tile crosses the causal diagonal, the
// window edge or S_k, and takes index masks; the other tiles take the row
// max of the raw scores and one FFMA (s * scale - m) before each exp2.
template <class C, bool EDGE>
__device__ __forceinline__ void softmax_tile(
    float (&s)[C::BK / 2], float (&m_i)[2], float (&l_i)[2],
    float (&alpha)[2], int kt, int qi0, int t4, int S_k, int causal,
    int window, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (EDGE) {
    // column c = 8j + (e & 1) of this thread's share (key kt + c + 2 t4)
    // is masked in row r when c > hc[r] (causal) or c <= lc[r] (window),
    // and is no key when c >= nk: one compare against a constant c each
    int hc[2], lc[2];
    const int nk = S_k - kt - 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      hc[r] = causal ? qi - kt - 2 * t4 : INT_MAX;
      lc[r] = INT_MIN;
      if (window > 0 && qi - window >= kt) lc[r] = qi - window - kt - 2 * t4;
    }
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1), r = e >> 1;
        float x = s[4 * j + e] * scale_log2;
        x = (c > hc[r] || c <= lc[r]) ? kMasked : x;
        x = c >= nk ? -INFINITY : x;  // no such key: exp(-inf - m) = 0
        s[4 * j + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  } else {
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // scale_log2 > 0 here (the caller sends other scales down EDGE)
    const float m_new = fmaxf(m_i[r], EDGE ? mx[r] : mx[r] * scale_log2);
    alpha[r] = fast_exp2(m_i[r] - m_new);
    m_i[r] = m_new;
    neg_m[r] = -m_new;
    l_i[r] *= alpha[r];  // this thread's share of the row sum
  }
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = s[4 * j + e];
      const float x =
          fast_exp2(EDGE ? y + neg_m[e >> 1] : fmaf(y, scale_log2, neg_m[e >> 1]));
      s[4 * j + e] = x;
      l_i[e >> 1] += x;
    }
}

// o rows g and g + 8 times their rescale factors
template <class C>
__device__ __forceinline__ void rescale(float (&o)[C::DP / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < C::DP / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// The bf16 A fragments of p . v: score columns 16kk .. 16kk + 15 (tiles
// 2kk and 2kk + 1 of the accumulator) are key step kk, registers
// p[4kk .. 4kk + 3], as wgmma takes A from registers.
template <class C>
__device__ __forceinline__ void to_p(const float (&s)[C::BK / 2],
                                     uint32_t (&p)[C::BK / 4]) {
#pragma unroll
  for (int i = 0; i < C::BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// One block's work: BQ query rows of one (batch, head) and the key tiles
// [kb, kb + n_tiles * BK) that any of its rows needs. Blocks are numbered
// heaviest first: the last query tiles of every head (the most key tiles
// under a causal mask), then the earlier ones, so the grid's tail is
// short tiles.
struct Work {
  int q0, b, h, kvh, kb, n_tiles;
};

// the tiles [lo, hi) of work tile x that rows r0 .. r0 + 63 need; none
// (lo = hi = n_tiles) when r0 is past S_q
template <class C>
__device__ __forceinline__ void consumer_tiles(const Work& x, int r0, int S_q,
                                               int S_k, int causal,
                                               int window, int& lo, int& hi) {
  lo = hi = x.n_tiles;
  if (r0 >= S_q) return;
  int kb, ke;
  key_range(r0, min(r0 + 63, S_q - 1), S_k, causal, window, kb, ke);
  lo = (kb / C::BK * C::BK - x.kb) / C::BK;
  hi = (ke - x.kb + C::BK - 1) / C::BK;
}

template <class C>
__device__ __forceinline__ Work work_tile(int w, int n_q, int S_q, int S_k,
                                          int H, int KV, int BH, int causal,
                                          int window) {
  Work x;
  const int bh = w % BH;
  x.q0 = (n_q - 1 - w / BH) * C::BQ;
  x.b = bh / H;
  x.h = bh % H;
  x.kvh = x.h / (H / KV);
  int ke;
  key_range(x.q0, min(x.q0 + C::BQ, S_q) - 1, S_k, causal, window, x.kb, ke);
  x.kb = x.kb / C::BK * C::BK;
  x.n_tiles = (ke - x.kb + C::BK - 1) / C::BK;
  return x;
}

// A consumer warpgroup's 64 query rows of the block's work: the running
// max and sum, the output accumulators and the score tile, in registers;
// key tile t lies in ring stage t % STAGES.
template <class C>
struct Consumer {
  uint32_t sK, sV, k_full, k_empty, v_full, v_empty;
  uint64_t dq;
  int kb, r0, r1, qi0, t4, S_k, causal, window;
  float scale_log2;
  bool signal;  // lane 0: a warp's one arrival on an empty barrier
  int turn;     // two consumers on the same key tiles: 0 or 1, whose turn
                // to issue products it waits for; -1: no turns
  float m_i[2], l_i[2], alpha[2];
  float o[C::DP / 2];
  float s[C::BK / 2];

  __device__ __forceinline__ int stage(int t) const {
    return t % C::STAGES;
  }
  __device__ __forceinline__ uint32_t parity(int t) const {
    return (t / C::STAGES) & 1;
  }
  // whether key tile t needs index masks for these rows
  __device__ __forceinline__ bool edge(int t) const {
    const int kt = kb + t * C::BK;
    return (causal && kt + C::BK - 1 > r0) ||
           (window > 0 && kt <= r1 - window) || kt + C::BK > S_k;
  }
  // a tile these rows do not need: released once it lands, so the ring
  // turns for the other consumer
  __device__ __forceinline__ void skip(int t) {
    const int st = stage(t);
    mbar_wait(k_full + 8 * st, parity(t));
    if (signal) mbar_arrive(k_empty + 8 * st);
    mbar_wait(v_full + 8 * st, parity(t));
    if (signal) mbar_arrive(v_empty + 8 * st);
  }
  // ping-pong: the two consumers issue their products in turns, so one's
  // softmax runs while the other's products hold the tensor cores
  __device__ __forceinline__ void my_turn() const {
    if (turn >= 0)
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + turn) : "memory");
  }
  __device__ __forceinline__ void your_turn() const {
    if (turn >= 0)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - turn) : "memory");
  }
  __device__ __forceinline__ void softmax(int t) {
    const int kt = kb + t * C::BK;
    if (edge(t) || !(scale_log2 > 0.0f))
      softmax_tile<C, true>(s, m_i, l_i, alpha, kt, qi0, t4, S_k, causal,
                            window, scale_log2);
    else
      softmax_tile<C, false>(s, m_i, l_i, alpha, kt, qi0, t4, S_k, causal,
                             window, scale_log2);
  }
  // the first tile: s, then its softmax, with nothing to overlap
  __device__ __forceinline__ void first(int t, uint32_t (&p)[C::BK / 4]) {
    const int st = stage(t);
    mbar_wait(k_full + 8 * st, parity(t));
    my_turn();
    wgmma_fence();
    issue_qk<C>(s, dq, sK + st * C::KV_BYTES);
    your_turn();
    wgmma_wait<0>();
    fence_regs(s);
    if (signal) mbar_arrive(k_empty + 8 * st);
    softmax(t);
    to_p<C>(s, p);
  }
  // tile t's s and its softmax while tile t-1's p.v runs; then p is
  // tile t's
  __device__ __forceinline__ void step(int t, uint32_t (&p)[C::BK / 4]) {
    const int st = stage(t), sp = stage(t - 1);
    mbar_wait(k_full + 8 * st, parity(t));
    fence_regs(p);
    my_turn();
    wgmma_fence();
    issue_qk<C>(s, dq, sK + st * C::KV_BYTES);
    rescale<C>(o, alpha);  // by tile t-1's factors, while s_t runs
    mbar_wait(v_full + 8 * sp, parity(t - 1));
    fence_regs(o);
    wgmma_fence();
    issue_pv<C>(o, p, sV + sp * C::KV_BYTES);
    your_turn();
    wgmma_wait<1>();  // s_t is in; p_{t-1} v_{t-1} may still run
    fence_regs(s);
    if (signal) mbar_arrive(k_empty + 8 * st);
    softmax(t);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (signal) mbar_arrive(v_empty + 8 * sp);
    to_p<C>(s, p);
  }
  // the last tile's p.v
  __device__ __forceinline__ void last(int t, uint32_t (&p)[C::BK / 4]) {
    const int st = stage(t);
    rescale<C>(o, alpha);
    mbar_wait(v_full + 8 * st, parity(t));
    fence_regs(o);
    fence_regs(p);
    my_turn();
    wgmma_fence();
    issue_pv<C>(o, p, sV + st * C::KV_BYTES);
    your_turn();
    wgmma_wait<0>();
    fence_regs(o);
    if (signal) mbar_arrive(v_empty + 8 * st);
  }
};

template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o, int B,
                        int S_q, int S_k, int H, int KV, float scale_log2,
                        int causal, int window) {
  using C = Cfg<DP, NC>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, CH = C::CH;
  extern __shared__ __align__(1024) unsigned char smem[];
  // tiles, each [chunk][row][128 bytes], 1024-byte aligned: q (one 64-row
  // tile a consumer, later its output) | K ring | V ring | barriers
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t q_full = sV + ST * C::KV_BYTES;
  const uint32_t k_full = q_full + 8 * NC, k_empty = k_full + 8 * ST;
  const uint32_t v_full = k_empty + 8 * ST, v_empty = v_full + 8 * ST;

  const int n_q = (S_q + BQ - 1) / BQ;
  const Work x = work_tile<C>(blockIdx.x, n_q, S_q, S_k, H, KV, B * H, causal,
                              window);

  if (threadIdx.x == 0) {
    for (int w = 0; w < NC; ++w) mbar_init(q_full + 8 * w, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * NC);  // one arrival a consumer warp
      mbar_init(v_empty + 8 * st, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    for (int cw = 0; cw < NC; ++cw) {
      mbar_expect_tx(q_full + 8 * cw, C::QW_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sQ + cw * C::QW_BYTES + c * 64 * kChunkRowBytes, &map_q,
                 q_full + 8 * cw, c * kChunk, x.h, x.q0 + 64 * cw, x.b);
    }
    for (int t = 0; t < x.n_tiles; ++t) {
      const int st = t % ST;
      const uint32_t parity = ((t / ST) & 1) ^ 1;  // a fresh slot passes
      const int kt = x.kb + t * BK;
      mbar_wait(k_empty + 8 * st, parity);
      mbar_expect_tx(k_full + 8 * st, C::KV_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sK + st * C::KV_BYTES + c * BK * kChunkRowBytes, &map_k,
                 k_full + 8 * st, c * kChunk, x.kvh, kt, x.b);
      mbar_wait(v_empty + 8 * st, parity);
      mbar_expect_tx(v_full + 8 * st, C::KV_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sV + st * C::KV_BYTES + c * BK * kChunkRowBytes, &map_v,
                 v_full + 8 * st, c * kChunk, x.kvh, kt, x.b);
    }
  } else {
    // ---------------------------------------------------------- consumer
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;                        // consumer index
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4;                       // fragment row
    const uint32_t q_tile = sQ + cw * C::QW_BYTES;
    Consumer<C> c;
    c.sK = sK;
    c.sV = sV;
    c.k_full = k_full;
    c.k_empty = k_empty;
    c.v_full = v_full;
    c.v_empty = v_empty;
    c.dq = make_desc(q_tile, 16, 1024);
    c.kb = x.kb;
    c.r0 = x.q0 + 64 * cw;                      // this consumer's rows
    c.r1 = min(c.r0 + 63, S_q - 1);
    c.qi0 = c.r0 + warp * 16 + g;               // a thread's: qi0, qi0 + 8
    c.t4 = lane % 4;
    c.S_k = S_k;
    c.causal = causal;
    c.window = window;
    c.scale_log2 = scale_log2;
    c.signal = lane == 0;
    // each consumer's own tiles [t_lo, t_hi) of the work tile's; none
    // past S_q. Where two consumers have the same tiles they take turns
    // (the same count of turns each, so neither waits for a turn that
    // never comes); the second lets the first go first.
    int t_lo, t_hi;
    consumer_tiles<C>(x, c.r0, S_q, S_k, causal, window, t_lo, t_hi);
    c.turn = -1;
    if (C::PINGPONG) {
      int lo, hi;  // the other consumer's
      consumer_tiles<C>(x, x.q0 + 64 * (1 - cw), S_q, S_k, causal, window,
                        lo, hi);
      if (lo == t_lo && hi == t_hi && t_lo < t_hi) {
        c.turn = cw;
        if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      }
    }
    // tiles before its first (and every tile, for rows past S_q): released
    // once they land, so the ring turns for the other consumer
    for (int t = 0; t < t_lo; ++t) c.skip(t);
    if (t_lo == t_hi) return;

    c.m_i[0] = c.m_i[1] = kMasked;
    c.l_i[0] = c.l_i[1] = 0.0f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) c.o[i] = 0.0f;
    mbar_wait(q_full + 8 * cw, 0);
    uint32_t p[BK / 4];
    c.first(t_lo, p);
    for (int t = t_lo + 1; t < t_hi; ++t) c.step(t, p);
    c.last(t_hi - 1, p);

    // out = o * (1 / max(l, 1e-30)), rounded once, into this consumer's q tile
    // (swizzled as TMA reads it), then one TMA store a chunk, which clips
    // rows past S_q and columns past D
    float inv[2];  // one division a row, then products
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = c.l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / fmaxf(l, 1e-30f);
    }
    const int row = warp * 16 + g;  // and row + 8; both = g mod 8
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const uint32_t at = q_tile + (j / 8) * 64 * kChunkRowBytes +
                          (((j % 8) ^ g) * 16) + c.t4 * 4;
      const uint32_t lo =
          pack_bf16(c.o[4 * j] * inv[0], c.o[4 * j + 1] * inv[0]);
      const uint32_t hi =
          pack_bf16(c.o[4 * j + 2] * inv[1], c.o[4 * j + 3] * inv[1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + row * 128), "r"(lo)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + (row + 8) * 128),
                   "r"(hi)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (tid == 0) {
      for (int ch = 0; ch < CH; ++ch)
        tma_store(&map_o, q_tile + ch * 64 * kChunkRowBytes, ch * kChunk, x.h,
                  c.r0, x.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, resolved once through the runtime, so the
// library links nothing beyond cudart
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, S, heads, D) bf16 tensor at `ptr` as a 4-D map (D, heads, S, B),
// boxes of 64 columns x 1 head x `rows` rows x 1 batch in the 128-byte
// swizzle; reads past any dimension's end give zeros, stores are clipped.
bool encode(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B,
            int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S_q, int S_k, int H, int KV, int D, float sm_scale, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<DP, NC>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<DP, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  CUtensorMap mq, mk, mv, mo;
  if (!encode(&mq, q, D, H, S_q, B, 64) || !encode(&mk, k, D, KV, S_k, B, C::BK) ||
      !encode(&mv, v, D, KV, S_k, B, C::BK) || !encode(&mo, o, D, H, S_q, B, 64))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((S_q + C::BQ - 1) / C::BQ) * B * H;
  flash_fwd_kernel_tc<DP, NC><<<(unsigned)blocks, C::THREADS, C::SMEM,
                                stream>>>(
      mq, mk, mv, mo, B, S_q, S_k, H, KV, sm_scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_width(int head_dim_pad, const void* q, const void* k,
                 const void* v, void* o, int B, int S_q, int S_k, int H,
                 int KV, int D, float sm_scale, int causal, int window,
                 cudaStream_t st) {
  switch (head_dim_pad) {
    case 64:
      return launch<64, NC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                            causal, window, st);
    case 128:
      return launch<128, NC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                             causal, window, st);
    default:
      return launch<256, NC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                             causal, window, st);
  }
}

}  // namespace

// q, o: (B, S_q, H, D); k, v: (B, S_k, KV, D); contiguous bfloat16.
// H % KV == 0, 8 <= D <= head_dim_pad with D % 8 == 0 and every pointer
// 16-byte aligned (TMA's rule for bases and row strides: the caller stages
// other inputs), head_dim_pad in {64, 128, 256} (the caller's bucket),
// q_rows in {64, 128}: the query rows a block, 64 for each consumer
// warpgroup (the caller's pick by shape). window > 0 keeps keys
// k > q - window; causal != 0 keeps k <= q. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// rules or a tensor map the driver will not encode.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S_q, int S_k, int H, int KV,
                                           int D, float sm_scale, int causal,
                                           int window, void* stream,
                                           int head_dim_pad, int q_rows) {
  const bool bucket_ok =
      (head_dim_pad == 64 || head_dim_pad == 128 || head_dim_pad == 256) &&
      D >= 8 && D <= head_dim_pad && D % 8 == 0;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)o) % 16 == 0;
  if (!bucket_ok || !aligned || (q_rows != 64 && q_rows != 128) || B < 1 ||
      S_q < 1 || S_k < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (q_rows == 128)
    return launch_width<2>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                           sm_scale, causal, window, st);
  return launch_width<1>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                         sm_scale, causal, window, st);
}
