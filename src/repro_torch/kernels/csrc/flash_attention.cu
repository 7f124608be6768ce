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
// block owns one (batch*head, 64-row query tile) and walks the key tiles in
// a loop of its own, keeping the same float32 online softmax:
//
//   s     = (q . k) * sm_scale, masked to -1e30 (causal k <= q; window
//           k > q - window)
//   m_new = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(p);  acc = alpha * acc + p v
//   out   = acc / max(l, 1e-30), rounded once into the input dtype
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
// the CUDA cores' float32 peak of 67 TFLOP/s, so operations bound it. The
// kernel is held back further by shared-memory reads. What the design does:
// the q tile (64 rows) and each key and value tile (32 rows) are staged
// once in shared memory as float32, rows padded by one word so the four
// threads of a query row and the eight rows of a warp read distinct banks;
// each thread keeps 8 scores and D/4 accumulator columns in registers, and
// a row's max and sum are two warp shuffles. D=256 needs 137 KB of shared
// memory, above the 48 KB default, so the launch opts in first.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBQ;  // threads per query row (4)
constexpr int kNC = kBK / kTPR;       // score columns per thread (8)
constexpr int kMaxD = 256;
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// NACC: accumulator columns per thread, a power of two >= D / 4.
template <typename T, int NACC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S_q,
                     int S_k, int H, int KV, int D, float sm_scale,
                     int causal, int window) {
  extern __shared__ float sh[];
  const int ldq = D + 1;
  float* Qs = sh;                    // (kBQ, D+1)
  float* Ks = Qs + kBQ * ldq;        // (kBK, D+1)
  float* Vs = Ks + kBK * ldq;        // (kBK, D)
  float* Ps = Vs + kBK * D;          // (kBQ, kBK+1)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, cg = tid % kTPR;
  const long long q_stride = (long long)H * D;    // between sequence rows
  const long long kv_stride = (long long)KV * D;
  const T* qb = q + ((long long)b * S_q * H + h) * D;
  const T* kb = k + ((long long)b * S_k * KV + kvh) * D;
  const T* vb = v + ((long long)b * S_k * KV + kvh) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int qi = q0 + rr;
    Qs[rr * ldq + dd] = qi < S_q ? to_f32(qb[qi * q_stride + dd]) : 0.0f;
  }

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

  const int qi = q0 + r;
  float m_i = kMasked, l_i = 0.0f;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the q tile is in; the last tile's reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int cc = i / D, dd = i % D;
      const int kj = kt + cc;
      float kx = 0.0f, vx = 0.0f;
      if (kj < S_k) {
        kx = to_f32(kb[kj * kv_stride + dd]);
        vx = to_f32(vb[kj * kv_stride + dd]);
      }
      Ks[cc * ldq + dd] = kx;
      Vs[cc * D + dd] = vx;
    }
    __syncthreads();

    float s[kNC];
#pragma unroll
    for (int c = 0; c < kNC; ++c) s[c] = 0.0f;
    const float* qrow = Qs + r * ldq;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        s[c] = fmaf(qv, Ks[(cg + kTPR * c) * ldq + dd], s[c]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int kj = kt + cg + kTPR * c;
      float val;
      if (kj >= S_k) {
        val = -INFINITY;  // no such key: exp(-inf - m) = 0
      } else {
        val = s[c] * sm_scale;
        bool ok = true;
        if (causal) ok = kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        if (!ok) val = kMasked;
      }
      s[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      s[c] = expf(s[c] - m_new);
      rs += s[c];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float alpha = expf(m_i - m_new);
    l_i = alpha * l_i + rs;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] *= alpha;

    float* prow = Ps + r * (kBK + 1);
#pragma unroll
    for (int c = 0; c < kNC; ++c) prow[cg + kTPR * c] = s[c];
    __syncwarp();  // a row's four threads share one warp
    for (int cc = 0; cc < kBK; ++cc) {
      const float p = prow[cc];
      const float* vrow = Vs + cc * D;
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int dd = cg + kTPR * j;
        if (dd < D) acc[j] = fmaf(p, vrow[dd], acc[j]);
      }
    }
  }

  if (qi < S_q) {
    const float den = fmaxf(l_i, 1e-30f);
    T* orow = o + ((long long)b * S_q + qi) * q_stride + (long long)h * D;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int dd = cg + kTPR * j;
      if (dd < D) store(orow + dd, acc[j] / den);
    }
  }
}

template <typename T, int NACC>
int launch_nacc(const void* q, const void* k, const void* v, void* o, int B,
                int S_q, int S_k, int H, int KV, int D, float sm_scale,
                int causal, int window, cudaStream_t stream) {
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((S_q + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, NACC><<<grid, kThreads, smem_bytes(D), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S_q, S_k, H, KV, D,
      sm_scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S_q, int S_k, int H, int KV, int D, float sm_scale, int causal,
           int window, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int need = (D + kTPR - 1) / kTPR;
  if (need <= 4)
    return launch_nacc<T, 4>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                             causal, window, st);
  if (need <= 8)
    return launch_nacc<T, 8>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                             causal, window, st);
  if (need <= 16)
    return launch_nacc<T, 16>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                              causal, window, st);
  if (need <= 32)
    return launch_nacc<T, 32>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                              causal, window, st);
  return launch_nacc<T, 64>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale,
                            causal, window, st);
}

}  // namespace

// q, o: (B, S_q, H, D); k, v: (B, S_k, KV, D); contiguous float32.
// H % KV == 0, 1 <= D <= 256, B * H <= 65535 (checked by the caller).
// window > 0 keeps keys k > q - window; causal != 0 keeps k <= q.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int S_q, int S_k, int H, int KV,
                                          int D, float sm_scale, int causal,
                                          int window, void* stream) {
  return launch<float>(q, k, v, o, B, S_q, S_k, H, KV, D, sm_scale, causal,
                       window, stream);
}
