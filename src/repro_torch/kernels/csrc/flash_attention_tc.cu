// Forward flash attention for bfloat16 q, k, v on Hopper's tensor cores,
// over the model's (B, S, H, D) layout.
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
//   out   = acc / max(l, 1e-30), rounded once to bfloat16
//
// with m starting at -1e30 and l, acc at 0, so a row with no allowed key
// averages every value. The TPU kernel's two products are one bf16 pass
// on the MXU at default precision; here they are bf16 tensor-core products
// with float32 accumulators (mma.sync m16n8k16): q.k^T is exact per product
// and differs only in summation order, and p is rounded to bf16 before
// p.v as the MXU rounds it. The softmax runs in float32 in registers, in
// the log2 domain (exp2f of scores prescaled by sm_scale * log2(e)).
//
// What bounds it on the H100: at the Gemma-7B prefill shape (4, 1024, 16,
// 256) causal it must move 134 MB of q, k, v and o (40 us at 3.35 TB/s)
// and do 4*B*H*D*sum(allowed pairs) = 34.4 GFLOP (35 us on the bf16 tensor
// cores' 989 TFLOP/s): both bounds are close. The kernel before this one
// ran float32 FMAs on the CUDA cores, one scalar shared-memory load per
// FMA, with inputs widened to float32 in shared memory and loads that did
// not overlap compute. What this design does about it:
//   * one block of 4 warps owns one (64-row query tile, batch*head); each
//     warp owns 16 query rows, the M of mma.sync, and keeps its scores,
//     its running max and sum, and its 16 x D output accumulators in
//     registers. q stays in shared memory and its fragments are reloaded
//     per k16 step (held in registers it would spill at D = 256);
//   * operands reach the tensor cores through ldmatrix (k as the .col B
//     operand as it lies, v through ldmatrix.trans), and p is reused from
//     the score accumulators as the A operand of p.v without touching
//     shared memory;
//   * everything in shared memory is bf16, rows padded by 16 bytes so the
//     eight rows an ldmatrix reads fall on distinct banks. The q tile is
//     loaded once; key and value tiles of BK keys are double-buffered and
//     filled with 16-byte cp.async (zero-filled past S_k and past D), so
//     tile j+1 is in flight while tile j computes. D = 256 takes BK = 32:
//     33 + 2 * (16.5 + 16.5) = 99 KB, two blocks per SM; D <= 128 takes
//     BK = 64;
//   * blocks are launched heaviest first: the linear block index walks the
//     query tiles from the last (most key tiles under a causal mask) to
//     the first across every head, so the grid's tail is short tiles;
//   * key tiles wholly above the causal diagonal or outside the window are
//     skipped, and masks by index are applied only to tiles that cross
//     the diagonal, the window edge or S_k.
// Padded widths: D is rounded up to 64, 128 or 256 (the wrapper picks
// it); padded q and k columns are zero and add 0 to the scores, padded
// output columns are not stored. D not a multiple of 8, or a pointer not
// 16-byte aligned, takes an element-wise loader inside the same kernel
// (template flag VEC = false). wgmma, TMA and warp specialisation are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tile {
  static constexpr int BK = DP == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = DP + 8;               // smem row, elements
  static constexpr int CPR = DP / 8;              // 16-byte chunks per row
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (size_t)LD * (kBQ + 4 * BK);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of a (S, *, D) operand into a padded shared
// tile; rows >= limit and columns >= D are zero.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int limit, int D, int tid) {
  using T = Tile<DP>;
  if (VEC) {
    static_assert(ROWS * T::CPR % kThreads == 0, "whole rounds of chunks");
    const uint32_t base = smem_addr(dst);
#pragma unroll
    for (int j = 0; j < ROWS * T::CPR / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / T::CPR, c = i % T::CPR;
      const bool ok = row0 + r < limit && c * 8 < D;
      const __nv_bfloat16* g = ok ? src + (row0 + r) * stride + c * 8 : src;
      cp_async16(base + (uint32_t)(r * T::LD + c * 8) * 2, g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      __nv_bfloat16 x = __float2bfloat16(0.0f);
      if (row0 + r < limit && d < D) x = src[(row0 + r) * stride + d];
      dst[r * T::LD + d] = x;
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int S_q, int S_k,
                        int H, int KV, int D, float scale_log2, int causal,
                        int window) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * LD;         // 2 stages of (BK, LD)
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;      // 2 stages of (BK, LD)

  // heaviest first: the last query tiles of every head, then the earlier
  const int n_q = (S_q + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_q;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBQ;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * D;  // between sequence rows
  const long long kv_stride = (long long)KV * D;
  const __nv_bfloat16* qb = q + ((long long)b * S_q * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * S_k * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * S_k * KV + kvh) * D;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row, column pair

  // key tiles that can hold an allowed key for some row of this block
  const int q_last = min(q0 + kBQ, S_q) - 1;
  int k_begin = 0, k_end = S_k;
  const bool row_without_keys =
      window > 0 && (long long)q_last - window >= (long long)S_k - 1;
  if (!row_without_keys) {
    if (causal) k_end = min(S_k, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  // group 0: the q tile and the first key/value tile
  load_tile<DP, kBQ, VEC>(Qs, qb, q_stride, q0, S_q, D, tid);
  load_tile<DP, BK, VEC>(Ks, kb, kv_stride, k_begin, S_k, D, tid);
  load_tile<DP, BK, VEC>(Vs, vb, kv_stride, k_begin, S_k, D, tid);
  cp_async_commit();

  // per-lane ldmatrix addresses (bytes). A from q: rows lane % 16, column
  // block lane / 16. B from k (x4 = two n8 tiles of keys, both k8 halves):
  // key lane % 8 + 8 * (lane / 16), column 8 * (lane / 8 % 2). B from v
  // (.trans, x4 = both k8 halves of keys, two n8 tiles of columns): key
  // lane % 8 + 8 * (lane / 8 % 2), column 8 * (lane / 16).
  const uint32_t q_addr =
      smem_addr(Qs) + ((warp * 16 + lane % 16) * LD + lane / 16 * 8) * 2;
  const uint32_t k_off =
      ((lane % 8 + lane / 16 * 8) * LD + lane / 8 % 2 * 8) * 2;
  const uint32_t v_off =
      ((lane % 8 + lane / 8 % 2 * 8) * LD + lane / 16 * 8) * 2;
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  constexpr uint32_t kStageBytes = BK * LD * 2;

  const int qi0 = q0 + warp * 16 + g;  // this thread's rows: qi0, qi0 + 8
  float m_i[2] = {kMasked, kMasked}, l_i[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  int stage = 0;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    if (kt + BK < k_end) {  // the next tile into the other stage
      load_tile<DP, BK, VEC>(Ks + (stage ^ 1) * BK * LD, kb, kv_stride,
                             kt + BK, S_k, D, tid);
      load_tile<DP, BK, VEC>(Vs + (stage ^ 1) * BK * LD, vb, kv_stride,
                             kt + BK, S_k, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();

    // s = q . k^T, (16 rows, BK keys) per warp
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const uint32_t k_addr = k_base + stage * kStageBytes + k_off;
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kd * 32);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, k_addr + np * 16 * LD * 2 + kd * 32);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // masks by index, only where this tile crosses an edge
    const bool edge = (causal && kt + BK - 1 > q0) ||
                      (window > 0 && kt <= q0 + kBQ - 1 - window) ||
                      kt + BK > S_k;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kj = kt + n * 8 + 2 * t4 + (e & 1);
          const int qi = qi0 + (e >> 1) * 8;
          if (kj >= S_k) {
            x = -INFINITY;  // no such key: exp(-inf - m) = 0
          } else {
            bool ok = true;
            if (causal) ok = kj <= qi;
            if (window > 0) ok = ok && kj > qi - window;
            if (!ok) x = kMasked;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];  // this thread's share of the row sum
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_i[e >> 1]);
        l_i[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p . v: the C fragments of score tiles 2kk and 2kk+1 are the
    // A fragment of key step kk
    const uint32_t v_addr = v_base + stage * kStageBytes + v_off;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_addr + kk * 16 * LD * 2 + dp * 32);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), rounded once; staged through this warp's
  // own q rows (no other warp reads them) for 16-byte stores
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* orows = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(orows + g * LD + col) =
        __floats2bfloat162_rn(acc[n][0] / den[0], acc[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(orows + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + ((long long)b * S_q * H + h) * D;
  if (VEC) {
    for (int i = lane; i < 16 * T::CPR; i += 32) {
      const int r = i / T::CPR, c = i % T::CPR;
      const int qi = q0 + warp * 16 + r;
      if (qi < S_q && c * 8 < D)
        *reinterpret_cast<uint4*>(ob + qi * q_stride + c * 8) =
            *reinterpret_cast<const uint4*>(orows + r * LD + c * 8);
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, d = i % DP;
      const int qi = q0 + warp * 16 + r;
      if (qi < S_q && d < D) ob[qi * q_stride + d] = orows[r * LD + d];
    }
  }
}

template <int DP, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S_q, int S_k, int H, int KV, int D, float sm_scale, int causal,
           int window, cudaStream_t stream) {
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<DP, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<DP>::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_kernel_tc<DP, VEC>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const long long blocks = (long long)((S_q + kBQ - 1) / kBQ) * B * H;
  flash_fwd_kernel_tc<DP, VEC><<<(unsigned)blocks, kThreads, Tile<DP>::kSmem,
                                  stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S_q, S_k, H, KV, D,
      sm_scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_vec(int head_dim_pad, const void* q, const void* k, const void* v,
               void* o, int B, int S_q, int S_k, int H, int KV, int D,
               float sm_scale, int causal, int window, cudaStream_t st) {
  switch (head_dim_pad) {
    case 64:
      return launch<64, VEC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                             causal, window, st);
    case 128:
      return launch<128, VEC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                              causal, window, st);
    default:
      return launch<256, VEC>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                              causal, window, st);
  }
}

}  // namespace

// q, o: (B, S_q, H, D); k, v: (B, S_k, KV, D); contiguous bfloat16.
// H % KV == 0, 1 <= D <= head_dim_pad, head_dim_pad in {64, 128, 256}
// (the caller's bucket), vec16 != 0 only when D % 8 == 0 and every pointer
// is 16-byte aligned (the caller's choice of loader; both are re-checked
// here). window > 0 keeps keys k > q - window; causal != 0 keeps k <= q.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an inconsistent bucket or loader.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S_q, int S_k, int H, int KV,
                                           int D, float sm_scale, int causal,
                                           int window, void* stream,
                                           int head_dim_pad, int vec16) {
  const bool bucket_ok =
      (head_dim_pad == 64 || head_dim_pad == 128 || head_dim_pad == 256) &&
      D >= 1 && D <= head_dim_pad;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)o) % 16 == 0;
  if (!bucket_ok || (vec16 && (D % 8 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    return launch_vec<true>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                            sm_scale, causal, window, st);
  return launch_vec<false>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                           sm_scale, causal, window, st);
}
