// The gradient of RMSNorm over the last axis, y = x * r * scale with
// r = rsqrt(mean(x^2) + eps):
//
//   dx       = r * (g - x * r^2 * mean(g * x)),  g = dy * scale
//   dscale_j = sum over rows of dy_j * x_j * r
//
// in float32, dx rounded once into x's dtype. It is the backward of the
// forward kernel csrc/rmsnorm.cu, which replaces the TPU kernel
// src/repro/kernels/rmsnorm.py::_rmsnorm_kernel. The JAX package has no
// backward kernel: its training forward is plain jnp
// (src/repro/models/layers.py::rmsnorm) and jax.grad differentiates it;
// this is that gradient.
//
// Two passes, no atomics, so two launches agree bit for bit:
//
//   * rmsnorm_bwd_rows: the row layout of the forward (rmsnorm.py:
//     rmsnorm_layout: 16-byte chunks of 8 bf16 or 4 float32 values held in
//     registers, or one element where d or a pointer does not allow it; a
//     row wider than 32 threads' work a block of whole warps, narrower rows
//     a power-of-two share of a warp). A row's threads are a "lane", and a
//     lane walks a fixed slab of consecutive rows. For each row it reads x
//     and dy once, sums x^2 and g*x together (warp shuffles, then one
//     shared array summed in a fixed order), writes dx, and adds
//     dy * (x * r) into per-column registers. A thread owns the same
//     columns in every row, so at the end of its slab it writes its
//     columns' sums as one row of a (lanes, d) float32 partial.
//   * rmsnorm_bwd_cols: dscale_j = the partial's column j summed over the
//     lanes in a fixed order: 32 threads a column each sum a strided
//     share, then one thread adds the 32 shares in order.
//
// What bounds it on the H100: bytes. At the training shape (8192, 3072)
// bf16 it must read x and dy and write dx, 151 MB, 0.045 ms at 3.35 TB/s;
// the partial (512 lanes x d float32, 6.3 MB) is written once and read
// once, mostly from L2. The wrapper (rmsnorm.py: rmsnorm_bwd_cuda) picks
// the layout and the slab; the entry re-checks them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kColTile = 32;  // columns a cols block takes, and its rows

// The forward kernel's chunk helpers (each source builds alone).
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

// W: elements per chunk; NCH: chunks per thread; tpr threads a row (a
// power of two <= 32, blockDim.x / tpr lanes a block, or the whole block,
// one lane). Lane l takes rows [l * slab, (l + 1) * slab) that exist.
template <typename T, int W, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int d,
                     int tpr, int slab, long long lanes, float eps) {
  const int t = threadIdx.x % tpr;  // this thread's place in its row
  const long long lane =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool lane_live = lane < lanes;
  const int chunks = d / W;

  // the scale and the dscale sums of this thread's columns, for the slab
  float s[NCH][W];
  float acc[NCH][W];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
    if (i < chunks) {
      load_scale<W>(scale + i * W, s[j]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < W; ++e) acc[j][e] = 0.0f;
  }

  // every thread runs every step of the slab: the shuffles and barriers
  // need the whole warp and block, live or not
  for (int k = 0; k < slab; ++k) {
    const long long row = lane * slab + k;
    const bool live = lane_live && row < rows;
    const long long off = (live ? row : 0) * d;
    Chunk<T, W> cx[NCH], cg[NCH];
    float ss = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = t + j * tpr;
      if (live && i < chunks) {
        cx[j] = reinterpret_cast<const Chunk<T, W>*>(x + off)[i];
        cg[j] = reinterpret_cast<const Chunk<T, W>*>(dy + off)[i];
        float fx[W], fg[W];
        unpack(cx[j], fx);
        unpack(cg[j], fg);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ss = fmaf(fx[e], fx[e], ss);
          sgx = fmaf(fg[e] * s[j][e], fx[e], sgx);
        }
      }
    }
    for (int o = min(tpr, 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    if (tpr > 32) {  // uniform: the block is one lane
      __shared__ float part[2][kMaxThreads / 32];
      if (threadIdx.x % 32 == 0) {
        part[0][threadIdx.x / 32] = ss;
        part[1][threadIdx.x / 32] = sgx;
      }
      __syncthreads();
      ss = 0.0f;
      sgx = 0.0f;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) {
        ss += part[0][w];
        sgx += part[1][w];
      }
      __syncthreads();  // the next row writes part again
    }
    if (live) {
      const float r = rsqrtf(ss / (float)d + eps);
      const float c = r * r * (sgx / (float)d);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int i = t + j * tpr;
        if (i < chunks) {
          float fx[W], fg[W], out[W];
          unpack(cx[j], fx);
          unpack(cg[j], fg);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            out[e] = r * (fg[e] * s[j][e] - fx[e] * c);
            acc[j][e] = fmaf(fg[e], fx[e] * r, acc[j][e]);
          }
          store(dx + off + i * W, out);
        }
      }
    }
  }
  if (!lane_live) return;
  float* pr = partial + lane * d;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
    if (i < chunks) {
#pragma unroll
      for (int e = 0; e < W; ++e) pr[i * W + e] = acc[j][e];
    }
  }
}

// dscale[j] = sum over l < lanes of partial[l][j]; a (32, 32) block per 32
// columns: thread (c, r) sums lanes r, r + 32, ... of column c in order,
// then thread (c, 0) adds the 32 shares in order.
__global__ void __launch_bounds__(kColTile* kColTile)
    rmsnorm_bwd_cols(const float* __restrict__ partial, long long lanes,
                     int d, float* __restrict__ dscale) {
  __shared__ float share[kColTile][kColTile + 1];
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const long long col = (long long)blockIdx.x * kColTile + c;
  float sum = 0.0f;
  if (col < d) {
    for (long long l = r; l < lanes; l += kColTile)
      sum += partial[l * d + col];
  }
  share[r][c] = sum;
  __syncthreads();
  if (r == 0 && col < d) {
    float total = 0.0f;
    for (int k = 0; k < kColTile; ++k) total += share[k][c];
    dscale[col] = total;
  }
}

template <typename T, int W, int NCH>
int launch_rows(const void* x, const void* scale, const void* dy, void* dx,
                void* partial, long long rows, int d, float eps,
                cudaStream_t stream, int threads, int tpr, int slab,
                long long lanes) {
  const long long per_block = tpr > 32 ? 1 : threads / tpr;
  const long long blocks = (lanes + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_bwd_rows<T, W, NCH><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)x, (const float*)scale, (const T*)dy, (T*)dx,
      (float*)partial, rows, d, tpr, slab, lanes, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* x, const void* scale, const void* dy, void* dx,
                  void* partial, long long rows, int d, float eps,
                  cudaStream_t st, int threads, int tpr, int nch, int vec,
                  int slab, long long lanes) {
  constexpr int kVecW = 16 / (int)sizeof(T);
  if (vec) {
    switch (nch) {
      case 1:
        return launch_rows<T, kVecW, 1>(x, scale, dy, dx, partial, rows, d,
                                        eps, st, threads, tpr, slab, lanes);
      case 2:
        return launch_rows<T, kVecW, 2>(x, scale, dy, dx, partial, rows, d,
                                        eps, st, threads, tpr, slab, lanes);
      case 4:
        if constexpr (kVecW == 4)  // float32 only: bf16 rows stop at 2
          return launch_rows<T, kVecW, 4>(x, scale, dy, dx, partial, rows,
                                          d, eps, st, threads, tpr, slab,
                                          lanes);
        return (int)cudaErrorInvalidValue;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (nch) {
    case 1:
      return launch_rows<T, 1, 1>(x, scale, dy, dx, partial, rows, d, eps,
                                  st, threads, tpr, slab, lanes);
    case 2:
      return launch_rows<T, 1, 2>(x, scale, dy, dx, partial, rows, d, eps,
                                  st, threads, tpr, slab, lanes);
    case 4:
      return launch_rows<T, 1, 4>(x, scale, dy, dx, partial, rows, d, eps,
                                  st, threads, tpr, slab, lanes);
    case 8:
      return launch_rows<T, 1, 8>(x, scale, dy, dx, partial, rows, d, eps,
                                  st, threads, tpr, slab, lanes);
    case 16:
      return launch_rows<T, 1, 16>(x, scale, dy, dx, partial, rows, d, eps,
                                   st, threads, tpr, slab, lanes);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* dy, void* dx,
           void* partial, void* dscale, long long rows, int d, float eps,
           void* stream, int threads, int tpr, int nch, int vec, int slab,
           long long lanes) {
  constexpr int kVecW = 16 / (int)sizeof(T);
  const int w = vec ? kVecW : 1;
  const bool aligned = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy |
                        (uintptr_t)dx) % 16 == 0;
  const bool pow2 = tpr > 0 && (tpr & (tpr - 1)) == 0;
  const bool shape_ok =
      tpr <= 32 ? pow2 && threads % 32 == 0 && threads <= kMaxThreads
                : threads == tpr && tpr % 32 == 0 && tpr <= kMaxThreads;
  // every lane has at least one row, and the lanes cover every row
  const bool slabs_ok = slab >= 1 && lanes >= 0 &&
                        lanes * (long long)slab >= rows &&
                        (lanes == 0 || (lanes - 1) * (long long)slab < rows);
  if (d < 1 || rows < 0 || !shape_ok || !slabs_ok ||
      (vec && (d % w || !aligned)) || (long long)tpr * nch < d / w)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes > 0) {
    const int status = dispatch_rows<T>(x, scale, dy, dx, partial, rows, d,
                                        eps, st, threads, tpr, nch, vec,
                                        slab, lanes);
    if (status != (int)cudaSuccess) return status;
  }
  const unsigned col_blocks = (unsigned)((d + kColTile - 1) / kColTile);
  rmsnorm_bwd_cols<<<col_blocks, dim3(kColTile, kColTile), 0, st>>>(
      (const float*)partial, lanes, d, (float*)dscale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) row-major, contiguous, of one dtype; scale: (d,)
// float32; partial: (lanes, d) float32 scratch; dscale: (d,) float32 out.
// threads, tpr, nch, vec: the forward's layout (rmsnorm.py:
// rmsnorm_layout), with vec != 0 only when x, scale, dy and dx are 16-byte
// aligned; slab: rows a lane takes, lanes = ceil(rows / slab). Launches
// both passes on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a layout the kernels do not take.
extern "C" int rmsnorm_bwd_f32_launch(const void* x, const void* scale,
                                      const void* dy, void* dx, void* partial,
                                      void* dscale, long long rows, int d,
                                      float eps, void* stream, int threads,
                                      int tpr, int nch, int vec, int slab,
                                      long long lanes) {
  return launch<float>(x, scale, dy, dx, partial, dscale, rows, d, eps,
                       stream, threads, tpr, nch, vec, slab, lanes);
}

extern "C" int rmsnorm_bwd_bf16_launch(const void* x, const void* scale,
                                       const void* dy, void* dx,
                                       void* partial, void* dscale,
                                       long long rows, int d, float eps,
                                       void* stream, int threads, int tpr,
                                       int nch, int vec, int slab,
                                       long long lanes) {
  return launch<__nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows, d,
                               eps, stream, threads, tpr, nch, vec, slab,
                               lanes);
}
