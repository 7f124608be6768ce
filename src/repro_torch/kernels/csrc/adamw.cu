// AdamW's step in two kernels: the global norm's sum of squares and the
// update of each param tensor.
//
// Replaces no TPU kernel: the reference's update (src/repro/optim/adamw.py)
// is plain jnp that XLA fuses. In the port the same arithmetic ran as some
// 25 PyTorch elementwise ops a slab (optim/adamw.py's plain route), each
// writing a float32 temporary to device memory and reading it back, about
// 200 bytes moved a param where a bf16 update needs 14.
//
// What bounds it on the H100: bytes. The update reads p, g, m and v once and
// writes p, m and v once (14 bytes a bf16 param, 26 with float32 moments);
// the norm reads g once more (2 bytes). At a few float32 operations a byte
// both sit far under the card's ridge point, so the design is about keeping
// enough bytes in flight and moving each one once:
//   * every tensor is read and written through its flat view in chunks of 16
//     bytes of the param's dtype (8 bf16 or 4 float32 elements; a float32
//     moment beside bf16 params is two 16-byte words a chunk), each thread
//     loading all its chunks of p, g, m and v before it computes
//     (kUpdateBytes a thread in flight), loads and stores marked streaming
//     (evict-first): no element is read twice;
//   * where the four pointers cannot all reach 16-byte alignment at one
//     element (a view off 16 bytes), the launcher (plan_of) picks
//     element-wise chunks; otherwise the elements before the first whole
//     chunk and after the last are taken element-wise by block 0;
//   * indices are 64-bit: the tied table of Command R+ has 3.15e9 elements.
//
// Exactness. The update is the plain route's arithmetic operation for
// operation, in its order, in float32 with round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn; the file is also built with
// --fmad=false and IEEE division and sqrt), and stores in the tensors'
// dtypes rounding to nearest even, as torch's copy does. Given the same clip,
// bias corrections and lr, which it reads as 0-d float32 tensors on the
// device (nothing syncs), it writes the plain route's params and moments bit
// for bit.
//
// The norm squares each element in float32, as the reference does, and sums
// the squares in float64: each thread over a fixed set of chunks (a grid-
// stride loop over a grid that depends on the tensor's size and dtype
// alone: sumsq_blocks), each
// block in a fixed order into one partial, and one block over every tensor's
// partials in a fixed order, which writes the float32 norm. No atomics: the
// norm is the same bits from run to run, and within float32 rounding of the
// exact sum over 4.7e9 squares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // both kernels' blocks
constexpr int kFinishThreads = 1024;  // the norm's last pass: one block
constexpr int kSumUnroll = 4;         // 16-byte chunks a norm thread loads
constexpr int kSumBlocks = 528;       // the norm's grid at most: 4 an SM
constexpr int kUpdateBytes = 256;     // bytes of p, g, m, v a thread loads

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t b) {
  return __uint_as_float(b << 16);
}

// 16 bytes of T as floats, and back (round to nearest even).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& w, float* f) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w,
                                                      float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half of word i
    f[2 * i] = bf16_bits_to_f32(u[i] & 0xffffu);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// One element, streaming.
__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_bits_to_f32(
      __ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store1(float* p, float f) { __stcs(p, f); }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float f) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16(f)));
}

// W elements of T: whole 16-byte words (W * sizeof(T) a multiple of 16), or
// one element (W == 1), held as loaded until the update needs them.
template <typename T, int W, bool kWords = (W > 1)>
struct Chunk;
template <typename T, int W>
struct Chunk<T, W, true> {
  static constexpr int kPer = 16 / (int)sizeof(T);  // elements in a word
  static constexpr int kN = W / kPer;
  uint4 w[kN];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      w[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i, w[i]);
  }
  __device__ __forceinline__ void get(float (&f)[W]) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) unpack<T>(w[i], f + i * kPer);
  }
  __device__ __forceinline__ void set(const float (&f)[W]) {
#pragma unroll
    for (int i = 0; i < kN; ++i) w[i] = pack<T>(f + i * kPer);
  }
};
template <typename T>
struct Chunk<T, 1, false> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = load1(p); }
  __device__ __forceinline__ void store(T* p) const { store1(p, v); }
  __device__ __forceinline__ void get(float (&f)[1]) const { f[0] = v; }
  __device__ __forceinline__ void set(const float (&f)[1]) { v = f[0]; }
};

struct Hyper {
  float b1, c1, b2, c2, eps, wd;  // c = 1 - b, rounded from double
};
struct Scalars {
  float clip, bc1, bc2, lr;
};

// optim/adamw.py's module docstring, in the plain route's order:
//   g32 = g * clip
//   m32 = m * b1 + (1 - b1) * g32
//   v32 = v * b2 + (1 - b2) * (g32 * g32)
//   delta = (m32 / bc1) / (sqrt(v32 / bc2) + eps) + wd * p
//   p = p - lr * delta
// A zero moment (a row of a table that no token reached) skips its
// divisions and sqrt, whose zero operands take the hardware's slow path:
// 0 / bc, sqrt(0) and 0 / den are that zero, sign kept, for bc and den
// above 0, which IEEE division gives too.
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, const Hyper& h,
                                           const Scalars& s) {
  const float g32 = __fmul_rn(g, s.clip);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g32));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.c2, __fmul_rn(g32, g32)));
  const float root =
      v == 0.0f && s.bc2 > 0.0f ? v : __fsqrt_rn(__fdiv_rn(v, s.bc2));
  const float den = __fadd_rn(root, h.eps);
  const float step = m == 0.0f && s.bc1 > 0.0f && den > 0.0f
                         ? m
                         : __fdiv_rn(__fdiv_rn(m, s.bc1), den);
  const float delta = __fadd_rn(step, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

// Elements [0, head) and [head + chunks * W, n): the ones outside whole
// chunks (fewer than 2W), one a thread of block 0; -1 past them.
template <int W>
__device__ __forceinline__ long long extra_index(long long n, long long head,
                                                 long long chunks) {
  const long long extra = n - chunks * W;
  const long long t = threadIdx.x;
  if (blockIdx.x != 0 || t >= extra) return -1;
  return t < head ? t : head + chunks * W + (t - head);
}

// Chunks an update thread loads: kUpdateBytes of p, g, m and v, 1 to 8.
template <typename TP, typename TM, int W>
struct UpdateUnroll {
  static constexpr int kRaw =
      kUpdateBytes / (W * 2 * (int)(sizeof(TP) + sizeof(TM)));
  static constexpr int value = kRaw < 1 ? 1 : (kRaw > 8 ? 8 : kRaw);
};

// One param tensor's update over its flat view. Chunk c covers elements
// head + c * W .. + W - 1; block b takes chunks b * kThreads * U + k *
// kThreads + threadIdx.x, k < U.
template <typename TP, typename TM, int W>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(TP* __restrict__ p, const TP* __restrict__ g,
                        TM* __restrict__ m, TM* __restrict__ v, long long n,
                        long long head, long long chunks,
                        const float* __restrict__ clip,
                        const float* __restrict__ bc1,
                        const float* __restrict__ bc2,
                        const float* __restrict__ lr, Hyper h) {
  constexpr int U = UpdateUnroll<TP, TM, W>::value;
  const Scalars s = {__ldg(clip), __ldg(bc1), __ldg(bc2), __ldg(lr)};
  const long long base =
      (long long)blockIdx.x * (kThreads * U) + threadIdx.x;

  Chunk<TP, W> cp[U], cg[U];
  Chunk<TM, W> cm[U], cv[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {  // every load in flight before any math
    const long long c = base + (long long)k * kThreads;
    if (c < chunks) {
      const long long e = head + c * W;
      cp[k].load(p + e);
      cg[k].load(g + e);
      cm[k].load(m + e);
      cv[k].load(v + e);
    }
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long c = base + (long long)k * kThreads;
    if (c < chunks) {
      float fp[W], fg[W], fm[W], fv[W];
      cp[k].get(fp);
      cg[k].get(fg);
      cm[k].get(fm);
      cv[k].get(fv);
#pragma unroll
      for (int j = 0; j < W; ++j)
        adamw_elem(fp[j], fg[j], fm[j], fv[j], h, s);
      cm[k].set(fm);
      cv[k].set(fv);
      cp[k].set(fp);
      const long long e = head + c * W;
      cm[k].store(m + e);
      cv[k].store(v + e);
      cp[k].store(p + e);
    }
  }
  const long long e = extra_index<W>(n, head, chunks);
  if (e >= 0) {
    float fp = load1(p + e), fm = load1(m + e), fv = load1(v + e);
    adamw_elem(fp, load1(g + e), fm, fv, h, s);
    store1(m + e, fm);
    store1(v + e, fv);
    store1(p + e, fp);
  }
}

// The block's sum of x in a fixed order (a butterfly in each warp, then the
// warps in order); valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kFinishThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)blockDim.x / 32; ++w) total += warp_sums[w];
  return total;
}

// One gradient's sum of squares: one float64 partial a block.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const T* __restrict__ g, long long n, long long head,
                 long long chunks, double* __restrict__ partial) {
  double acc = 0.0;
  const long long stride = (long long)gridDim.x * kThreads * kSumUnroll;
  for (long long c0 = (long long)blockIdx.x * kThreads * kSumUnroll +
                      threadIdx.x;
       c0 < chunks; c0 += stride) {
    Chunk<T, W> cg[kSumUnroll];
#pragma unroll
    for (int k = 0; k < kSumUnroll; ++k) {
      const long long c = c0 + (long long)k * kThreads;
      if (c < chunks) cg[k].load(g + head + c * W);
    }
#pragma unroll
    for (int k = 0; k < kSumUnroll; ++k) {
      const long long c = c0 + (long long)k * kThreads;
      if (c < chunks) {
        float f[W];
        cg[k].get(f);
#pragma unroll
        for (int j = 0; j < W; ++j) acc += (double)__fmul_rn(f[j], f[j]);
      }
    }
  }
  const long long e = extra_index<W>(n, head, chunks);
  if (e >= 0) {
    const float f = load1(g + e);
    acc += (double)__fmul_rn(f, f);
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// The norm from every partial: sqrt of their sum, rounded to float32.
__global__ void __launch_bounds__(kFinishThreads)
    norm_finish_kernel(const double* __restrict__ partial, long long count,
                       float* __restrict__ out) {
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kFinishThreads)
    acc += partial[i];
  const double total = block_sum(acc);
  if (threadIdx.x == 0) *out = (float)sqrt(total);
}

// How a kernel walks a flat tensor of n elements: chunks of W elements from
// element head, the first at which every pointer is 16-byte aligned, and
// the elements before head and after the last chunk (fewer than W each) one
// at a time; where no element aligns them all (a view off 16 bytes that the
// others are not), chunks of one element.
struct Plan {
  long long head, chunks;
  bool vec;
};
template <int W>
Plan plan_of(long long n, const void* const* ptrs, const int* sizes,
             int count) {
  for (int h = 0; h < W; ++h) {
    bool aligned = true;
    for (int i = 0; i < count; ++i)
      aligned = aligned &&
                ((uintptr_t)ptrs[i] + (uintptr_t)h * sizes[i]) % 16 == 0;
    if (aligned) {
      const long long head = h < n ? h : n;
      return {head, (n - head) / W, true};
    }
  }
  return {0, n, false};
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The norm's grid for one gradient of n elements of T: a block a kThreads x
// kSumUnroll 16-byte chunks, at most kSumBlocks. It depends on n and T
// alone, so a gradient's sum is the same bits from call to call.
template <typename T>
int sumsq_blocks(long long n) {
  const long long chunks = ceil_div(n, 16 / (long long)sizeof(T));
  const long long b = ceil_div(chunks, (long long)kThreads * kSumUnroll);
  return (int)(b < 1 ? 1 : (b > kSumBlocks ? kSumBlocks : b));
}

template <typename TP, typename TM, int W>
int update_one(void* p, const void* g, void* m, void* v, long long n,
               long long head, long long chunks, const float* clip,
               const float* bc1, const float* bc2, const float* lr,
               const Hyper& h, cudaStream_t st) {
  constexpr int U = UpdateUnroll<TP, TM, W>::value;
  const long long blocks =
      chunks > 0 ? ceil_div(chunks, (long long)kThreads * U) : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adamw_update_kernel<TP, TM, W><<<(unsigned)blocks, kThreads, 0, st>>>(
      (TP*)p, (const TP*)g, (TM*)m, (TM*)v, n, head, chunks, clip, bc1, bc2,
      lr, h);
  return (int)cudaGetLastError();
}

template <typename TP, typename TM>
int update(void* p, const void* g, void* m, void* v, long long n,
           const float* clip, const float* bc1, const float* bc2,
           const float* lr, const Hyper& h, void* stream) {
  constexpr int kW = 16 / (int)sizeof(TP);
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const void* ptrs[4] = {p, g, m, v};
  const int sizes[4] = {(int)sizeof(TP), (int)sizeof(TP), (int)sizeof(TM),
                        (int)sizeof(TM)};
  const Plan pl = plan_of<kW>(n, ptrs, sizes, 4);
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.vec)
    return update_one<TP, TM, kW>(p, g, m, v, n, pl.head, pl.chunks, clip,
                                  bc1, bc2, lr, h, st);
  return update_one<TP, TM, 1>(p, g, m, v, n, pl.head, pl.chunks, clip, bc1,
                               bc2, lr, h, st);
}

template <typename T>
int sumsq(const void* g, long long n, double* partial, void* stream) {
  constexpr int kW = 16 / (int)sizeof(T);
  if (n < 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[1] = {g};
  const int sizes[1] = {(int)sizeof(T)};
  const Plan pl = plan_of<kW>(n, ptrs, sizes, 1);
  const int blocks = sumsq_blocks<T>(n);
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.vec)
    sumsq_kernel<T, kW><<<blocks, kThreads, 0, st>>>((const T*)g, n, pl.head,
                                                     pl.chunks, partial);
  else
    sumsq_kernel<T, 1><<<blocks, kThreads, 0, st>>>((const T*)g, n, pl.head,
                                                    pl.chunks, partial);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.
//
// The number of float64 partials adamw_sumsq_launch writes for a gradient
// of n elements of `dtype` (1 to 528), or -1 for an unknown dtype: a
// count, not a cudaError_t.
extern "C" int adamw_sumsq_blocks(long long n, int dtype) {
  switch (dtype) {
    case 0:
      return sumsq_blocks<float>(n);
    case 1:
      return sumsq_blocks<__nv_bfloat16>(n);
    default:
      return -1;
  }
}

// One gradient's sum of squares into adamw_sumsq_blocks(n, dtype) float64
// partials at `partial`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int adamw_sumsq_launch(const void* g, int dtype, long long n,
                                  void* partial, void* stream) {
  switch (dtype) {
    case 0:
      return sumsq<float>(g, n, (double*)partial, stream);
    case 1:
      return sumsq<__nv_bfloat16>(g, n, (double*)partial, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float32 norm into `out` from `count` float64 partials: one block.
extern "C" int adamw_norm_finish_launch(const void* partial, long long count,
                                        void* out, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  norm_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(
      (const double*)partial, count, (float*)out);
  return (int)cudaGetLastError();
}

// One param tensor's update in place: p and g of the param dtype, m and v
// of the moment dtype ((param, moment): (bf16, bf16), (bf16, float32),
// (float32, float32)), each `n` elements contiguous; clip, bc1, bc2, lr:
// 0-d float32 tensors on the device; b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps
// and the weight decay by value.
extern "C" int adamw_update_launch(void* p, const void* g, void* m, void* v,
                                   int pdtype, int mdtype, long long n,
                                   const void* clip, const void* bc1,
                                   const void* bc2, const void* lr, float b1,
                                   float c1, float b2, float c2, float eps,
                                   float wd, void* stream) {
  const Hyper h = {b1, c1, b2, c2, eps, wd};
  const float *cl = (const float*)clip, *b1c = (const float*)bc1,
              *b2c = (const float*)bc2, *l = (const float*)lr;
  if (pdtype == 1 && mdtype == 1)
    return update<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, cl, b1c, b2c,
                                                l, h, stream);
  if (pdtype == 1 && mdtype == 0)
    return update<__nv_bfloat16, float>(p, g, m, v, n, cl, b1c, b2c, l, h,
                                        stream);
  if (pdtype == 0 && mdtype == 0)
    return update<float, float>(p, g, m, v, n, cl, b1c, b2c, l, h, stream);
  return (int)cudaErrorInvalidValue;
}
