// Fused RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel,
// which normalised a (256, d) row block held in VMEM per grid step. Here
// one warp owns one row: each lane sums the squares of its strided slice
// in float32, a butterfly of warp shuffles gives every lane the row's sum,
// and the second pass writes x * rsqrtf(mean + eps) * scale, rounded once
// into x's dtype. The scale arrives in float32 (the wrapper casts it), as
// the reference multiplies by scale.astype(float32).
//
// What bounds it on the H100: bytes. Per row it reads d inputs and writes
// d outputs with about 4 float32 operations per element, far below the
// card's 67 TFLOP/s float32 rate against its 3.35 TB/s; the least time is
// (x + y + scale bytes) / 3.35 TB/s. The design reads each row once from
// device memory (the second pass finds it in L1/L2: a row is at most
// 12 KB in float32 at d = 3072), keeps the reduction in registers, and
// lets neighbouring lanes touch neighbouring addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, long long rows, int d,
                               float eps) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    store(yr + i, to_f32(xr[i]) * r * scale[i]);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    rmsnorm_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const T*)x, (const float*)scale, (T*)y, rows, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) row-major, contiguous, of one dtype; scale: (d,) float32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int rmsnorm_f32_launch(const void* x, const void* scale, void* y,
                                  long long rows, int d, float eps,
                                  void* stream) {
  return launch<float>(x, scale, y, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16_launch(const void* x, const void* scale, void* y,
                                   long long rows, int d, float eps,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, stream);
}
