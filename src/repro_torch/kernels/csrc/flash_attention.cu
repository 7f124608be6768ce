// Forward flash attention for float32 q, k, v over the model's (B, S, H, D)
// layout, on the CUDA cores.
//
// Replaces the float32 route of the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel; bfloat16 inputs take
// the tensor-core kernel of flash_attention_tc.cu. The tensor cores take
// float32 only as TF32 (about three decimal digits), which would not hold
// the float32 tolerance of 2e-5 against the plain version.
//
// The TPU kernel ran a sequential (B*H, n_q, n_k) grid and carried the running
// max, denominator and accumulator in VMEM scratch from one k block to the
// next. Blocks on the H100 run in parallel and in no order, so here one
// block owns one (64-row query tile, batch*head) and walks the key tiles in
// a loop of its own, keeping the same float32 online softmax:
//
//   s     = (q . k) * sm_scale, masked to -1e30 (causal k <= q; window
//           k > q - window)
//   m_new = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(p);  acc = alpha * acc + p v
//   out   = acc / max(l, 1e-30)
//
// with m starting at -1e30 and l, acc at 0, as _flash_kernel does.
// Differences from the TPU kernel that the contract allows:
//   * q is read from (B, S_q, H, D) and k, v from (B, S_k, KV, D) in place;
//     query head h reads kv head h / (H / KV), the grouping of the model's
//     grouped-query attention. No transposed or broadcast copy is made.
//   * any S_q and S_k: the last tiles are masked; keys past S_k add no
//     term at all (score -inf, value 0).
//   * key tiles wholly above the causal diagonal or wholly outside the
//     window are skipped: they would add exact zeros (exp(-1e30 - m) = 0
//     in float32) to every row that has an allowed key. A tile holding a
//     row with no allowed key at all (possible only when S_q > S_k with a
//     window) walks every key tile, as the TPU kernel does, so such a row
//     gets the same uniform average.
//
// What bounds it on the H100: at the Gemma-7B prefill shape (4, 1024, 16,
// 256) in float32 it must move 268 MB of q, k, v and o (80 us at
// 3.35 TB/s) and do 4*B*H*D*sum(allowed pairs) = 34.4 GFLOP, 0.51 ms at
// the CUDA cores' float32 peak of 67 TFLOP/s, so operations bound it. A
// warp issues one FMA instruction a clock on each of the SM's four
// quarters, and shared memory gives 128 bytes a clock, so the FMAs stay
// ahead only if each shared-memory load feeds many of them. What this
// design does:
//   * register micro-tiles: 256 threads, thread (rg, cg) with rg = tid / 16
//     and cg = tid % 16 owns query rows 4rg..4rg+3. For q . k^T it holds a
//     4 x 4 block of scores (keys cg + 16j), built from float4 loads along
//     d: 8 LDS.128 per 64 FMAs. For p . v it holds those 4 rows x D/16
//     columns (4cg + 64c .. +3) of the accumulator, 64 registers at
//     D = 256: per key one float4 of p and D/64 float4s of v, 5 LDS.128
//     per 64 FMAs at D = 256. A row's 16 threads are one half warp, so
//     its max is four shuffles, and the same threads own the row in both
//     products: alpha never leaves registers. p goes through a small
//     key-major shared tile that only its own warp reads;
//   * shared memory: the q tile (64 rows), one k tile and one v tile
//     (64 keys each), rows padded by 16 bytes so that the loads above hit
//     distinct banks, and the p tile: 212 KB at D = 256, one block per
//     SM. Tiles come in by 16-byte cp.async, zero-filled past S_k and D.
//     k and v have a buffer each and take turns: the next k tile loads
//     while this tile's softmax and p . v run, the next v tile while the
//     next q . k^T runs;
//   * blocks are launched heaviest first: the linear block index walks the
//     query tiles from the last (most key tiles under a causal mask) to
//     the first across every head, so the grid's tail is short tiles.
// Padded widths: D is rounded up to 64, 128 or 256 (the wrapper picks it,
// as for the tensor-core kernel); padded columns are zero and are not
// stored. D not a multiple of 4, or a pointer not 16-byte aligned, takes
// an element-wise loader inside the same kernel (template flag VEC =
// false), also the wrapper's choice.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 key/column groups
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = 4;       // keys per thread in a score tile
constexpr int kGroup = 16;     // threads sharing a row group: a half warp
constexpr float kMasked = -1e30f;

template <int DP>
struct Tile {
  static constexpr int LD = DP + 4;     // q, k, v rows in shared memory
  static constexpr int LDP = kBQ + 4;   // p rows (one per key)
  static constexpr int CPR = DP / 4;    // 16-byte chunks per row
  static constexpr int NC4 = DP / 64;   // accumulator float4s per row
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * LD + (size_t)kBK * LDP);
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + ROWS) of a (S, *, D) operand into a padded shared
// tile; rows >= limit and columns >= D are zero.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
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
      const bool ok = row0 + r < limit && c * 4 < D;
      const float* g = ok ? src + (row0 + r) * stride + c * 4 : src;
      cp_async16(base + (uint32_t)(r * T::LD + c * 4) * 4, g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      float x = 0.0f;
      if (row0 + r < limit && d < D) x = src[(row0 + r) * stride + d];
      dst[r * T::LD + d] = x;
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S_q, int S_k, int H, int KV, int D, float sm_scale,
                     int causal, int window) {
  using T = Tile<DP>;
  constexpr int LD = T::LD, LDP = T::LDP, NC4 = T::NC4;
  extern __shared__ __align__(16) float sh[];
  float* Qs = sh;              // (kBQ, LD)
  float* Ks = Qs + kBQ * LD;   // (kBK, LD)
  float* Vs = Ks + kBK * LD;   // (kBK, LD)
  float* Ps = Vs + kBK * LD;   // (kBK, LDP): p by key, then row

  // heaviest first: the last query tiles of every head, then the earlier
  const int n_q = (S_q + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_q;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBQ;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * D;  // between sequence rows
  const long long kv_stride = (long long)KV * D;
  const float* qb = q + ((long long)b * S_q * H + h) * D;
  const float* kb = k + ((long long)b * S_k * KV + kvh) * D;
  const float* vb = v + ((long long)b * S_k * KV + kvh) * D;

  const int tid = threadIdx.x;
  const int rg = tid / kGroup;  // rows 4rg .. 4rg+3
  const int cg = tid % kGroup;  // keys cg + 16j; columns 4cg + 64c

  // key tiles that can hold an allowed key for some row of this block
  const int q_last = min(q0 + kBQ, S_q) - 1;
  int k_begin = 0, k_end = S_k;
  const bool row_without_keys =
      window > 0 && (long long)q_last - window >= (long long)S_k - 1;
  if (!row_without_keys) {
    if (causal) k_end = min(S_k, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;

  // groups in flight: (q, k tile), (v tile), then one k and one v group
  // per key tile (empty after the last)
  load_tile<DP, kBQ, VEC>(Qs, qb, q_stride, q0, S_q, D, tid);
  load_tile<DP, kBK, VEC>(Ks, kb, kv_stride, k_begin, S_k, D, tid);
  cp_async_commit();
  load_tile<DP, kBK, VEC>(Vs, vb, kv_stride, k_begin, S_k, D, tid);
  cp_async_commit();

  float m_i[kRows], l_i[kRows];
  float4 acc[kRows][NC4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int D4 = (D + 3) / 4;  // float4 steps of q . k (padding is zero)
  const float* qrow = Qs + kRows * rg * LD;
  const float* krow = Ks + cg * LD;
  const float* pcol = Ps + kRows * rg;
  const float* vcol = Vs + 4 * cg;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    cp_async_wait<1>();  // this k tile (and, first, q) has landed
    __syncthreads();

    // s = q . k^T: rows 4rg + i, keys kt + cg + 16j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 a[kRows], bk[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ld4(qrow + i * LD + 4 * d4);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        bk[j] = ld4(krow + j * kGroup * LD + 4 * d4);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every warp is done with this k tile
    if (kt + kBK < k_end)
      load_tile<DP, kBK, VEC>(Ks, kb, kv_stride, kt + kBK, S_k, D, tid);
    cp_async_commit();

    // masks, then the online softmax of each row across its half warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + kRows * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = kt + cg + kGroup * j;
        float val;
        if (kj >= S_k) {
          val = -INFINITY;  // no such key: exp(-inf - m) = 0
        } else {
          val = s[i][j] * sm_scale;
          bool ok = true;
          if (causal) ok = kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          if (!ok) val = kMasked;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      m_i[i] = m_new;
      l_i[i] *= alpha;  // this thread's share of the row sum
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        l_i[i] += s[i][j];
      }
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(Ps + (cg + kGroup * j) * LDP + kRows * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_async_wait<1>();  // this v tile has landed
    __syncthreads();     // and p is written

    // acc += p . v over the tile's keys (p = 0 past S_k, v = 0 there)
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = ld4(pcol + kk * LDP);
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        const float4 w = ld4(vcol + kk * LD + 64 * c);
        const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][c].x = fmaf(pr[i], w.x, acc[i][c].x);
          acc[i][c].y = fmaf(pr[i], w.y, acc[i][c].y);
          acc[i][c].z = fmaf(pr[i], w.z, acc[i][c].z);
          acc[i][c].w = fmaf(pr[i], w.w, acc[i][c].w);
        }
      }
    }
    __syncthreads();  // every warp is done with this v tile
    if (kt + kBK < k_end)
      load_tile<DP, kBK, VEC>(Vs, vb, kv_stride, kt + kBK, S_k, D, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30); a row's sum is its 16 threads' shares
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float den = fmaxf(l, 1e-30f);
    const int qi = q0 + kRows * rg + i;
    if (qi >= S_q) continue;
    float* orow = o + ((long long)b * S_q + qi) * q_stride + (long long)h * D;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      const int col = 4 * cg + 64 * c;
      const float out[4] = {acc[i][c].x / den, acc[i][c].y / den,
                            acc[i][c].z / den, acc[i][c].w / den};
      if (VEC) {
        if (col < D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = out[e];
      }
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
        flash_fwd_kernel<DP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Tile<DP>::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_kernel<DP, VEC>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const long long blocks = (long long)((S_q + kBQ - 1) / kBQ) * B * H;
  flash_fwd_kernel<DP, VEC><<<(unsigned)blocks, kThreads, Tile<DP>::kSmem,
                              stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S_q, S_k,
      H, KV, D, sm_scale, causal, window);
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

// q, o: (B, S_q, H, D); k, v: (B, S_k, KV, D); contiguous float32.
// H % KV == 0, B * H <= 65535 (checked by the caller), 1 <= D <=
// head_dim_pad, head_dim_pad in {64, 128, 256} (the caller's bucket),
// vec16 != 0 only when D % 4 == 0 and every pointer is 16-byte aligned
// (the caller's choice of loader; both are re-checked here). window > 0
// keeps keys k > q - window; causal != 0 keeps k <= q.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an inconsistent bucket or loader.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
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
  if (!bucket_ok || (vec16 && (D % 4 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    return launch_vec<true>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                            sm_scale, causal, window, st);
  return launch_vec<false>(head_dim_pad, q, k, v, o, B, S_q, S_k, H, KV, D,
                           sm_scale, causal, window, st);
}
