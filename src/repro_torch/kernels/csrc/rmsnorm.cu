// Fused RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel,
// which normalised a (256, d) row block held in VMEM per grid step. Here
// a row is split into chunks of 16 bytes (8 bf16 or 4 float32 values) or,
// where the row or a pointer does not allow that, of one element; each
// thread of the row holds its NCH chunks of x in registers from the one
// read of device memory to the write. The row's sum of squares is taken in
// float32: each thread's share, a butterfly of warp shuffles, and, for a
// row wider than a warp, one small shared array summed by every thread in
// the same order (no atomics, so two launches agree bit for bit). The
// output is x * rsqrtf(mean + eps) * scale, rounded once into x's dtype.
// The scale arrives in float32 (the wrapper casts it), as the reference
// multiplies by scale.astype(float32), and is read as float4 (L2 keeps its
// d values warm across rows).
//
// What bounds it on the H100: bytes at the prefill shape, where per row it
// reads d inputs and writes d outputs with about 4 float32 operations per
// element (the least time is (x + y + scale bytes) / 3.35 TB/s), and the
// launch at the decode shape, where (4, 3072) bf16 moves 61 KB. The design
// gives a row enough threads that one 16-byte load each covers it: a row
// of more than 32 chunks takes a block of its own (d = 3072 bf16: 384
// threads), narrower rows share a 256-thread block, 32 / tpr rows a warp,
// so the 4 rows of a decode step are 4 blocks of 12 warps.
//
// The wrapper (rmsnorm.py: rmsnorm_layout) picks threads per block, threads
// per row, chunks per thread and the chunk width; the entry re-checks them.
// Nothing falls back at run time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// One chunk of W elements of T, raw as it lies in memory.
template <typename T, int W>
struct Chunk;
template <>
struct Chunk<float, 4> {
  float4 v;
};
template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 v;
};
template <typename T>
struct Chunk<T, 1> {
  T v;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ void unpack(const Chunk<float, 4>& c,
                                       float (&f)[4]) {
  f[0] = c.v.x;
  f[1] = c.v.y;
  f[2] = c.v.z;
  f[3] = c.v.w;
}
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16, 8>& c,
                                       float (&f)[8]) {
  const uint32_t w[4] = {c.v.x, c.v.y, c.v.z, c.v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <typename T>
__device__ __forceinline__ void unpack(const Chunk<T, 1>& c, float (&f)[1]) {
  f[0] = to_f32(c.v);
}

__device__ __forceinline__ void store(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
template <typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[1]) {
  from_f32(p, f[0]);
}

template <int W>
__device__ __forceinline__ void load_scale(const float* p, float (&s)[W]) {
  if constexpr (W == 1) {
    s[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
  }
}

// W: elements per chunk (16 bytes, or 1); NCH: chunks per thread. A row
// has tpr threads: tpr <= 32 is a power of two and a block holds
// blockDim.x / tpr rows; tpr > 32 is the whole block, one row.
template <typename T, int W, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long rows, int d, int tpr,
                   float eps) {
  const int t = threadIdx.x % tpr;  // this thread's place in its row
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;  // the last block's spare rows
  const int chunks = d / W;
  const T* xr = x + (live ? row : 0) * d;

  // The 16-byte paths read their scale chunks with x, before the sum;
  // the element-wise path keeps its registers for x (one an element, up
  // to 16 at 1024 threads a block) and reads the scale after the sum.
  constexpr bool kEarlyScale = W > 1;
  Chunk<T, W> c[NCH];
  float s[NCH][W];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
    if (live && i < chunks) {
      c[j] = reinterpret_cast<const Chunk<T, W>*>(xr)[i];
      if (kEarlyScale) load_scale<W>(scale + i * W, s[j]);
      float f[W];
      unpack(c[j], f);
#pragma unroll
      for (int e = 0; e < W; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  // every lane takes part in the shuffles, live or not
  for (int off = min(tpr, 32) / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // uniform: the block is one row
    __shared__ float part[kMaxThreads / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) ss += part[w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
    if (i < chunks) {
      if (!kEarlyScale) load_scale<W>(scale + i * W, s[j]);
      float f[W];
      unpack(c[j], f);
#pragma unroll
      for (int e = 0; e < W; ++e) f[e] = f[e] * r * s[j][e];
      store(yr + i * W, f);
    }
  }
}

template <typename T, int W, int NCH>
int launch_one(const void* x, const void* scale, void* y, long long rows,
               int d, float eps, cudaStream_t stream, int threads, int tpr) {
  const long long per_block = tpr > 32 ? 1 : threads / tpr;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T, W, NCH><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)x, (const float*)scale, (T*)y, rows, d, tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, void* stream, int threads, int tpr, int nch, int vec) {
  constexpr int kVecW = 16 / (int)sizeof(T);
  const int w = vec ? kVecW : 1;
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)y) % 16 == 0;
  const bool pow2 = tpr > 0 && (tpr & (tpr - 1)) == 0;
  const bool shape_ok =
      tpr <= 32 ? pow2 && threads % 32 == 0 && threads <= kMaxThreads
                : threads == tpr && tpr % 32 == 0 && tpr <= kMaxThreads;
  if (d < 1 || rows < 0 || !shape_ok || (vec && (d % w || !aligned)) ||
      (long long)tpr * nch < d / w)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    switch (nch) {
      case 1:
        return launch_one<T, kVecW, 1>(x, scale, y, rows, d, eps, st,
                                       threads, tpr);
      case 2:
        return launch_one<T, kVecW, 2>(x, scale, y, rows, d, eps, st,
                                       threads, tpr);
      case 4:
        if constexpr (kVecW == 4)  // float32 only: bf16 rows stop at 2
          return launch_one<T, kVecW, 4>(x, scale, y, rows, d, eps, st,
                                         threads, tpr);
        return (int)cudaErrorInvalidValue;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (nch) {
    case 1:
      return launch_one<T, 1, 1>(x, scale, y, rows, d, eps, st, threads, tpr);
    case 2:
      return launch_one<T, 1, 2>(x, scale, y, rows, d, eps, st, threads, tpr);
    case 4:
      return launch_one<T, 1, 4>(x, scale, y, rows, d, eps, st, threads, tpr);
    case 8:
      return launch_one<T, 1, 8>(x, scale, y, rows, d, eps, st, threads, tpr);
    case 16:
      return launch_one<T, 1, 16>(x, scale, y, rows, d, eps, st, threads,
                                  tpr);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (rows, d) row-major, contiguous, of one dtype; scale: (d,) float32.
// threads: block size; tpr: threads per row (a power of two <= 32, or the
// whole block, a multiple of 32 <= 1024); nch: chunks per thread, with
// tpr * nch chunks covering the row; vec != 0: 16-byte chunks, only when
// d is a whole number of them and x, scale, y are 16-byte aligned. The
// caller's choice (rmsnorm.py: rmsnorm_layout) is re-checked here.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a layout the kernel does not take.
extern "C" int rmsnorm_f32_launch(const void* x, const void* scale, void* y,
                                  long long rows, int d, float eps,
                                  void* stream, int threads, int tpr, int nch,
                                  int vec) {
  return launch<float>(x, scale, y, rows, d, eps, stream, threads, tpr, nch,
                       vec);
}

extern "C" int rmsnorm_bf16_launch(const void* x, const void* scale, void* y,
                                   long long rows, int d, float eps,
                                   void* stream, int threads, int tpr,
                                   int nch, int vec) {
  return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, stream, threads,
                               tpr, nch, vec);
}
