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
// What bounds it on the H100: bytes. It must read x and dy and write dx
// once, about 10 float32 operations an element against 6 bytes (bf16), so
// (8192, 3072) bf16 needs 0.045 ms at 3.35 TB/s and Qwen3's QK-norm rows
// (65,536, 128) 0.015 ms. A row is short work between long waits for
// device memory, so what decides the time is how many bytes every SM
// keeps in flight: by Little's law 3.35 TB/s x ~1 us of latency over 132
// SMs is ~25 KB an SM. The design:
//
//   * The row layout is the forward's (rmsnorm.py: rmsnorm_layout):
//     16-byte chunks of 8 bf16 or 4 float32 values, or one element where
//     d or a pointer does not allow it. A row's threads are a "lane".
//   * The grid follows the rows (rmsnorm.py: rmsnorm_bwd_slabs): one wave
//     of blocks that an SM surely holds at once (3 narrow blocks, or 1024
//     threads of block-per-row blocks, on each of 132 SMs, a named
//     constant there), a lane taking the fewest rows that keep the grid
//     within it. QK-norm's (65,536, 128) is 373 blocks of 16 lanes of 11
//     rows, (8192, 3072) 256 blocks of 32 rows.
//   * Narrow rows (rmsnorm_bwd_narrow: a row of at most 32 threads' work,
//     L = 256 / tpr lanes a block): block b takes rows [b L S, (b + 1) L
//     S), lane j its rows b L S + j + k L, k < S, so a block's step reads
//     L consecutive rows. A register double buffer issues row k + 1's
//     16-byte loads before row k's shuffles.
//   * Wide rows (rmsnorm_bwd_wide: a block a row, whole warps): block b
//     takes rows [b S, (b + 1) S). A ring of up to 3 rows of x and dy in
//     shared memory is fed by 16-byte cp.async, 2 rows ahead of the one
//     reduced: each thread copies only the chunks it reads back, so the
//     ring needs no barrier of its own. The row's two sums cross warps
//     through a double-buffered shared array, so a row costs one
//     __syncthreads. The element-wise path (an unaligned pointer) and
//     rows whose ring would not fit (float32 past d = 14336) load
//     straight into registers.
//   * dscale without atomics, in a fixed order: each lane adds its rows'
//     dy * x * r into per-column registers in row order; a narrow block
//     then adds its lanes in lane order through shared memory, so the
//     float32 partial has one row a block, never one a lane; the column
//     pass (rmsnorm_bwd_cols) adds the blocks' rows in a fixed order. The
//     partition and this tree depend on (N, d, dtype, alignment) alone, so
//     two launches agree bit for bit.
//
// Measured on an H100 80GB HBM3 at 700 W, both passes together move
// (8192, 3072)'s 151 MB at about 2.5 TB/s, near the 2.67 TB/s the forward
// kernel reaches at that shape; a deeper ring, 1-D bulk copies (TMA) in
// place of cp.async, streaming stores and a 256-byte L2 prefetch hint did
// not move it.
//
// The wrapper (rmsnorm.py: rmsnorm_bwd_cuda) picks the layout and the
// partition; the entry re-checks them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kNarrowThreads = 256;  // the narrow path's block
constexpr int kMaxStages = 3;        // the wide path's ring of rows
constexpr int kRingBytes = 226 * 1024;  // the most the ring may take
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

template <typename T, int W>
__device__ __forceinline__ Chunk<T, W> load_chunk(const T* p) {
  return *reinterpret_cast<const Chunk<T, W>*>(p);
}

// One chunk's share of the row's sums of x^2 and g x.
template <typename T, int W>
__device__ __forceinline__ void row_sums(const Chunk<T, W>& cx,
                                         const Chunk<T, W>& cg,
                                         const float (&s)[W], float& ss,
                                         float& sgx) {
  float fx[W], fg[W];
  unpack(cx, fx);
  unpack(cg, fg);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    ss = fmaf(fx[e], fx[e], ss);
    sgx = fmaf(fg[e] * s[e], fx[e], sgx);
  }
}

// One chunk's dx, written to `out`, and its dscale terms added to `acc`;
// r = rsqrt(mean(x^2) + eps), c = r^2 mean(g x).
template <typename T, int W>
__device__ __forceinline__ void row_out(const Chunk<T, W>& cx,
                                        const Chunk<T, W>& cg,
                                        const float (&s)[W], float r,
                                        float c, T* out, float (&acc)[W]) {
  float fx[W], fg[W], o[W];
  unpack(cx, fx);
  unpack(cg, fg);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    o[e] = r * (fg[e] * s[e] - fx[e] * c);
    acc[e] = fmaf(fg[e], fx[e] * r, acc[e]);
  }
  store(out, o);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The block-per-row path's ring: each thread copies its own chunks of a
// row into shared memory with 16-byte cp.async, one commit group a row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// until at most n of this thread's groups are pending, n < kMaxStages
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0:
      cp_async_wait<0>();
      break;
    case 1:
      cp_async_wait<1>();
      break;
    default:
      cp_async_wait<2>();
      break;
  }
}

// Narrow rows: tpr threads a row (a power of two <= 32), L =
// kNarrowThreads / tpr lanes a block, one chunk a thread. Lane j of block
// b takes rows b L S + j + k L, k < slab, that exist; the block writes
// row b of the (blocks, d) partial.
template <typename T, int W>
__global__ void __launch_bounds__(kNarrowThreads)
    rmsnorm_bwd_narrow(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, long long rows, int d,
                       int tpr, int slab, float eps) {
  __shared__ float red[kNarrowThreads * W];  // (L, d): each lane's sums
  const int lanes = kNarrowThreads / tpr;
  const int lane = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;  // this thread's chunk of its row
  const bool mine = t < d / W;
  const long long first = (long long)blockIdx.x * lanes * slab + lane;

  float s[W], acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) s[e] = acc[e] = 0.0f;
  if (mine) load_scale<W>(scale + t * W, s);

  // every thread runs every step: the shuffles need the whole warp
  Chunk<T, W> cx{}, cg{}, nx{}, ng{};
  if (mine && first < rows) {
    cx = load_chunk<T, W>(x + first * d + t * W);
    cg = load_chunk<T, W>(dy + first * d + t * W);
  }
  for (int k = 0; k < slab; ++k) {
    const long long row = first + (long long)k * lanes;
    const bool live = mine && row < rows;
    const long long next = row + lanes;
    if (k + 1 < slab && mine && next < rows) {  // in flight over the sums
      nx = load_chunk<T, W>(x + next * d + t * W);
      ng = load_chunk<T, W>(dy + next * d + t * W);
    }
    float ss = 0.0f, sgx = 0.0f;
    if (live) row_sums<T, W>(cx, cg, s, ss, sgx);
    for (int o = tpr / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    if (live) {
      const float r = rsqrtf(ss / (float)d + eps);
      const float c = r * r * (sgx / (float)d);
      row_out<T, W>(cx, cg, s, r, c, dx + row * d + t * W, acc);
    }
    cx = nx;
    cg = ng;
  }

  // the block's dscale row: its lanes' sums added in lane order
  if (mine) {
#pragma unroll
    for (int e = 0; e < W; ++e) red[lane * d + t * W + e] = acc[e];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += kNarrowThreads) {
    float sum = 0.0f;
    for (int l = 0; l < lanes; ++l) sum += red[l * d + col];
    partial[(long long)blockIdx.x * d + col] = sum;
  }
}

// Wide rows: the block (tpr = blockDim.x threads, whole warps) is one
// lane; thread t owns chunks t + j tpr, j < NCH. Block b takes rows
// [b slab, (b + 1) slab) that exist and writes row b of the partial.
// stages > 1: rows arrive through a ring of `stages` (x, dy) rows in
// dynamic shared memory, fed by cp.async, stages - 1 rows ahead; a thread
// copies only the chunks it reads back, so the ring needs no barrier of
// its own; stages == 0: plain loads (RING false).
template <typename T, int W, int NCH, bool RING>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_wide(const T* __restrict__ x, const float* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int d,
                     int slab, int stages, float eps) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  __shared__ float part[2][2][kMaxThreads / 32];  // [row & 1][sum][warp]
  Chunk<T, W>* ring = reinterpret_cast<Chunk<T, W>*>(ring_bytes);
  const int t = threadIdx.x;
  const int tpr = blockDim.x;
  const int chunks = d / W;
  const long long first = (long long)blockIdx.x * slab;
  const int n = (int)min((long long)slab, rows - first);  // >= 1

  float s[NCH][W], acc[NCH][W];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
#pragma unroll
    for (int e = 0; e < W; ++e) s[j][e] = acc[j][e] = 0.0f;
    if (i < chunks) load_scale<W>(scale + i * W, s[j]);
  }

  // row k of the block into stage k % stages: x's chunks, then dy's
  auto issue = [&](int k) {
    if (k < n) {
      const long long off = (first + k) * d;
      Chunk<T, W>* st = ring + (k % stages) * 2 * chunks;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int i = t + j * tpr;
        if (i < chunks) {
          cp_async16(st + i, x + off + i * W);
          cp_async16(st + chunks + i, dy + off + i * W);
        }
      }
    }
    cp_async_commit();  // an empty group past the last row keeps the count
  };
  if constexpr (RING) {
    for (int k = 0; k < stages - 1; ++k) issue(k);
  }

  for (int k = 0; k < n; ++k) {
    const long long off = (first + k) * d;
    Chunk<T, W> cx[NCH], cg[NCH];
    if constexpr (RING) {
      // the stage refilled here held row k - 1, which this thread alone
      // read, and is done with
      issue(k + stages - 1);  // in flight over this row's sums
      cp_async_wait(stages - 1);
      const Chunk<T, W>* st = ring + (k % stages) * 2 * chunks;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int i = t + j * tpr;
        if (i < chunks) {
          cx[j] = st[i];
          cg[j] = st[chunks + i];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int i = t + j * tpr;
        if (i < chunks) {
          cx[j] = load_chunk<T, W>(x + off + i * W);
          cg[j] = load_chunk<T, W>(dy + off + i * W);
        }
      }
    }
    float ss = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      if (t + j * tpr < chunks) row_sums<T, W>(cx[j], cg[j], s[j], ss, sgx);
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    // part[k & 1] was last read in row k - 2, before row k - 1's barrier
    float(*pb)[kMaxThreads / 32] = part[k & 1];
    if (t % 32 == 0) {
      pb[0][t / 32] = ss;
      pb[1][t / 32] = sgx;
    }
    __syncthreads();
    // every thread holds row k: its stage takes row k + stages
    ss = 0.0f;
    sgx = 0.0f;
    for (int w = 0; w < tpr / 32; ++w) {
      ss += pb[0][w];
      sgx += pb[1][w];
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * r * (sgx / (float)d);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = t + j * tpr;
      if (i < chunks)
        row_out<T, W>(cx[j], cg[j], s[j], r, c, dx + off + i * W, acc[j]);
    }
  }

  float* pr = partial + (long long)blockIdx.x * d;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int i = t + j * tpr;
    if (i < chunks) {
#pragma unroll
      for (int e = 0; e < W; ++e) pr[i * W + e] = acc[j][e];
    }
  }
}

// dscale[j] = sum over b < parts of partial[b][j]; a (32, 32) block per
// 32 columns: thread (c, r) sums rows r, r + 32, ... of column c in order,
// then thread (c, 0) adds the 32 shares in order.
__global__ void __launch_bounds__(kColTile* kColTile)
    rmsnorm_bwd_cols(const float* __restrict__ partial, long long parts,
                     int d, float* __restrict__ dscale) {
  __shared__ float share[kColTile][kColTile + 1];
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const long long col = (long long)blockIdx.x * kColTile + c;
  float sum = 0.0f;
  if (col < d) {
    for (long long l = r; l < parts; l += kColTile)
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

struct Args {
  const void* x;
  const void* scale;
  const void* dy;
  void* dx;
  void* partial;
  long long rows;
  int d;
  float eps;
  cudaStream_t stream;
  int threads;
  int slab;
  long long blocks;
};

template <typename T, int W>
int launch_narrow(const Args& a, int tpr) {
  rmsnorm_bwd_narrow<T, W><<<(unsigned)a.blocks, kNarrowThreads, 0,
                             a.stream>>>(
      (const T*)a.x, (const float*)a.scale, (const T*)a.dy, (T*)a.dx,
      (float*)a.partial, a.rows, a.d, tpr, a.slab, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int W, int NCH, bool RING>
int launch_wide(const Args& a, int stages) {
  const size_t ring = (size_t)stages * 2 * a.d * sizeof(T);
  static bool raised = false;  // this kernel's cap, raised once
  if (RING && !raised) {       // past the 48 KB a launch gets by default
    const cudaError_t e =
        cudaFuncSetAttribute(rmsnorm_bwd_wide<T, W, NCH, RING>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  rmsnorm_bwd_wide<T, W, NCH, RING>
      <<<(unsigned)a.blocks, a.threads, ring, a.stream>>>(
          (const T*)a.x, (const float*)a.scale, (const T*)a.dy, (T*)a.dx,
          (float*)a.partial, a.rows, a.d, a.slab, stages, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int W, int NCH>
int launch_wide_ring(const Args& a, int stages) {
  if constexpr (W > 1) {  // cp.async moves 16-byte chunks only
    if (stages > 1) return launch_wide<T, W, NCH, true>(a, stages);
  }
  return stages == 0 ? launch_wide<T, W, NCH, false>(a, 0)
                     : (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_rows(const Args& a, int tpr, int nch, int vec, int stages) {
  constexpr int kVecW = 16 / (int)sizeof(T);
  if (tpr <= 32) {
    return vec ? launch_narrow<T, kVecW>(a, tpr) : launch_narrow<T, 1>(a, tpr);
  }
  if (vec) {
    switch (nch) {
      case 1:
        return launch_wide_ring<T, kVecW, 1>(a, stages);
      case 2:
        return launch_wide_ring<T, kVecW, 2>(a, stages);
      case 4:
        if constexpr (kVecW == 4)  // float32 only: bf16 rows stop at 2
          return launch_wide_ring<T, kVecW, 4>(a, stages);
        return (int)cudaErrorInvalidValue;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (nch) {
    case 1:
      return launch_wide_ring<T, 1, 1>(a, stages);
    case 2:
      return launch_wide_ring<T, 1, 2>(a, stages);
    case 4:
      return launch_wide_ring<T, 1, 4>(a, stages);
    case 8:
      return launch_wide_ring<T, 1, 8>(a, stages);
    case 16:
      return launch_wide_ring<T, 1, 16>(a, stages);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* dy, void* dx,
           void* partial, void* dscale, long long rows, int d, float eps,
           void* stream, int threads, int tpr, int nch, int vec, int slab,
           int lanes, long long blocks, int stages) {
  constexpr int kVecW = 16 / (int)sizeof(T);
  const int w = vec ? kVecW : 1;
  const bool aligned = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy |
                        (uintptr_t)dx) % 16 == 0;
  const bool pow2 = tpr > 0 && (tpr & (tpr - 1)) == 0;
  const bool narrow = tpr <= 32;
  const bool shape_ok =
      narrow ? pow2 && threads == kNarrowThreads &&
                   lanes == kNarrowThreads / tpr && nch == 1
             : threads == tpr && tpr % 32 == 0 && tpr <= kMaxThreads &&
                   lanes == 1;
  // every block has at least one row, and the blocks cover every row
  const long long per_block = (long long)lanes * slab;
  const bool slabs_ok = slab >= 1 && blocks >= 0 && blocks <= 0x7fffffffLL &&
                        blocks * per_block >= rows &&
                        (blocks == 0 || (blocks - 1) * per_block < rows);
  const bool ring_ok =
      stages == 0 ||
      (stages >= 2 && stages <= kMaxStages && vec && !narrow &&
       (long long)stages * 2 * d * (long long)sizeof(T) <= kRingBytes);
  if (d < 1 || rows < 0 || !shape_ok || !slabs_ok || !ring_ok ||
      (vec && (d % w || !aligned)) || (long long)tpr * nch < d / w)
    return (int)cudaErrorInvalidValue;
  const Args a{x,   scale, dy,     dx,      partial, rows,
               d,   eps,   (cudaStream_t)stream, threads, slab, blocks};
  if (blocks > 0) {
    const int status = dispatch_rows<T>(a, tpr, nch, vec, stages);
    if (status != (int)cudaSuccess) return status;
  }
  const unsigned col_blocks = (unsigned)((d + kColTile - 1) / kColTile);
  rmsnorm_bwd_cols<<<col_blocks, dim3(kColTile, kColTile), 0, a.stream>>>(
      (const float*)partial, blocks, d, (float*)dscale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) row-major, contiguous, of one dtype; scale: (d,)
// float32; partial: (blocks, d) float32 scratch; dscale: (d,) float32 out.
// threads, tpr, nch, vec: the forward's layout (rmsnorm.py:
// rmsnorm_layout), with vec != 0 only when x, scale, dy and dx are 16-byte
// aligned; slab, lanes, blocks, stages: the partition (rmsnorm.py:
// rmsnorm_bwd_slabs): rows a lane takes, lanes a block, blocks, and the
// wide path's ring stages (0, 2 or 3). Launches both passes on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a layout or a
// partition the kernels do not take.
extern "C" int rmsnorm_bwd_f32_launch(const void* x, const void* scale,
                                      const void* dy, void* dx, void* partial,
                                      void* dscale, long long rows, int d,
                                      float eps, void* stream, int threads,
                                      int tpr, int nch, int vec, int slab,
                                      int lanes, long long blocks,
                                      int stages) {
  return launch<float>(x, scale, dy, dx, partial, dscale, rows, d, eps,
                       stream, threads, tpr, nch, vec, slab, lanes, blocks,
                       stages);
}

extern "C" int rmsnorm_bwd_bf16_launch(const void* x, const void* scale,
                                       const void* dy, void* dx,
                                       void* partial, void* dscale,
                                       long long rows, int d, float eps,
                                       void* stream, int threads, int tpr,
                                       int nch, int vec, int slab, int lanes,
                                       long long blocks, int stages) {
  return launch<__nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows, d,
                               eps, stream, threads, tpr, nch, vec, slab,
                               lanes, blocks, stages);
}
