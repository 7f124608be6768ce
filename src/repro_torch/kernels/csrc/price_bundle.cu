// Masked price reductions and head-room for Algorithm 4's snapshot bundle.
//
// Replaces the TPU kernel src/repro/kernels/pricing.py::_pallas_bundle_call
// (a float32 (8, Rp) x (Hp, Rp)^T dot_general on the MXU, with the head-room
// rows left to the host in float64). Here all five rows come from one launch
// in float64, for every (slot, machine) of a (W, H, R) stack:
//
//   wprice[t,h] = sum_{k: wdem[k] != 0} price[t,h,k] * wdem[k]
//   sprice[t,h] = sum_{k: sdem[k] != 0} price[t,h,k] * sdem[k]
//   coloc[t,h]  = sum_k price[t,h,k] * coef[k]       (coef = wdem*gamma + sdem)
//   max_w[t,h]  = floor(max(min_{k: wdem[k] > 0} free[t,h,k] / wdem[k], 0))
//   max_s[t,h]  = the same with sdem            (+inf when no demand is > 0)
//
// Exactness: one thread per (t, h) accumulates over k = 0..R-1 in the numpy
// reference's order (price_bundle_batch_numpy), with a separate rounded
// multiply and add (__dmul_rn / __dadd_rn, and the file is built with
// --fmad=false) and a correctly rounded division (__ddiv_rn), so every
// output is bit-identical to the reference. The min keeps numpy's NaN
// propagation.
//
// What bounds it on the H100: at the main path's shape (W=20, H=100, R=4)
// the operands are 2 x 64 KB in and 80 KB out, under a microsecond at HBM
// rate and nothing for the float64 units: the kernel sits at the launch
// floor, and what a plan pays beyond it is the host's work around the
// launch. The design takes that work away:
//   * the three demand rows travel by value, as a kernel parameter of
//     3 x kRMax doubles (__grid_constant__: read in place from the
//     parameter bank), so a plan makes no host-to-device copy; the entry
//     forms coef = wdem * gamma + sdem on the host, a rounded product and
//     a rounded sum as numpy forms them;
//   * R is a template parameter (1..kRMax): the loops unroll, the demand
//     values are read from the parameter bank, a row sits in registers;
//   * where R is even and both operands are 16-byte aligned a row is read
//     as R/2 double2 loads, else element by element (the wrapper,
//     pricing.py: bundle_vec, chooses; the entry re-checks);
//   * the host entry launches, copies the five rows into pinned host
//     memory and syncs the stream in one call: the admission decision's
//     one sync point.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRMax = 8;
constexpr int kThreads = 128;

// wdem, sdem and coef, passed by value.
struct Demand {
  double w[kRMax];
  double s[kRMax];
  double c[kRMax];
};

__device__ __forceinline__ double nan_min(double m, double r) {
  // numpy's minimum: a NaN operand wins and stays
  return (r < m || isnan(r)) ? r : m;
}

template <int R>
__device__ __forceinline__ double headroom(const double (&f)[R],
                                           const double* dem) {
  bool any = false;
  double m = INFINITY;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const double d = dem[k];
    if (d > 0.0) {
      any = true;
      m = nan_min(m, __ddiv_rn(f[k], d));
    }
  }
  if (!any) return INFINITY;
  // np.maximum(m, 0.0): keeps m when m >= 0 or m is NaN
  m = (m >= 0.0 || isnan(m)) ? m : 0.0;
  return floor(m);
}

template <int R, int VEC>
__device__ __forceinline__ void load_row(const double* __restrict__ src,
                                         double (&x)[R]) {
  if (VEC == 2) {
    const double2* v = reinterpret_cast<const double2*>(src);
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const double2 p = __ldg(v + j);
      x[2 * j] = p.x;
      x[2 * j + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = __ldg(src + k);
  }
}

template <int R, int VEC>
__global__ void __launch_bounds__(kThreads)
    price_bundle_kernel(const double* __restrict__ price,
                        const double* __restrict__ free,
                        const __grid_constant__ Demand dem,
                        double* __restrict__ out, int WH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WH) return;
  double p[R], f[R];
  load_row<R, VEC>(price + (size_t)i * R, p);
  load_row<R, VEC>(free + (size_t)i * R, f);
  double wp = 0.0, sp = 0.0, co = 0.0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (dem.w[k] != 0.0) wp = __dadd_rn(wp, __dmul_rn(p[k], dem.w[k]));
    if (dem.s[k] != 0.0) sp = __dadd_rn(sp, __dmul_rn(p[k], dem.s[k]));
    co = __dadd_rn(co, __dmul_rn(p[k], dem.c[k]));
  }
  out[i] = wp;
  out[(size_t)WH + i] = sp;
  out[2 * (size_t)WH + i] = co;
  out[3 * (size_t)WH + i] = headroom<R>(f, dem.w);
  out[4 * (size_t)WH + i] = headroom<R>(f, dem.s);
}

template <int R, int VEC>
void launch_rv(const double* price, const double* free, const Demand& dem,
               double* out, int WH, cudaStream_t stream) {
  const int blocks = (WH + kThreads - 1) / kThreads;
  price_bundle_kernel<R, VEC>
      <<<blocks, kThreads, 0, stream>>>(price, free, dem, out, WH);
}

template <int R>
void launch_r(const double* price, const double* free, const Demand& dem,
              double* out, int WH, int vec, cudaStream_t stream) {
  if constexpr (R % 2 == 0) {
    if (vec == 2) return launch_rv<R, 2>(price, free, dem, out, WH, stream);
  }
  launch_rv<R, 1>(price, free, dem, out, WH, stream);
}

int launch(const double* price, const double* free, const double* dem_host,
           double gamma, double* out, int WH, int R, int vec,
           cudaStream_t stream) {
  // the wrapper's choices, re-checked
  if (R < 1 || R > kRMax || WH < 0) return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 2) return (int)cudaErrorInvalidValue;
  if (vec == 2 && (R % 2 != 0 || ((uintptr_t)price | (uintptr_t)free) % 16))
    return (int)cudaErrorInvalidValue;
  Demand dem;
  memset(&dem, 0, sizeof(dem));
  for (int k = 0; k < R; ++k) {
    dem.w[k] = dem_host[k];
    dem.s[k] = dem_host[R + k];
    // the product is rounded on its own: no fused multiply-add
    volatile double wg = dem.w[k] * gamma;
    dem.c[k] = wg + dem.s[k];
  }
  if (WH > 0) {
    switch (R) {
      case 1: launch_r<1>(price, free, dem, out, WH, vec, stream); break;
      case 2: launch_r<2>(price, free, dem, out, WH, vec, stream); break;
      case 3: launch_r<3>(price, free, dem, out, WH, vec, stream); break;
      case 4: launch_r<4>(price, free, dem, out, WH, vec, stream); break;
      case 5: launch_r<5>(price, free, dem, out, WH, vec, stream); break;
      case 6: launch_r<6>(price, free, dem, out, WH, vec, stream); break;
      case 7: launch_r<7>(price, free, dem, out, WH, vec, stream); break;
      default: launch_r<8>(price, free, dem, out, WH, vec, stream); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// price, free: (WH, R) row-major float64 on the device; dem_host: wdem then
// sdem, R float64 each, in host memory (read before the call returns);
// gamma: the co-location factor; out: (5, WH) on the device; vec: 2 for
// double2 loads, 1 for element loads. Launches on `stream`; returns a
// cudaError_t (cudaErrorInvalidValue for R outside 1..8 or a vec it does
// not allow).
extern "C" int price_bundle_launch(const double* price, const double* free,
                                   const double* dem_host, double gamma,
                                   double* out, int WH, int R, int vec,
                                   void* stream) {
  return launch(price, free, dem_host, gamma, out, WH, R, vec,
                (cudaStream_t)stream);
}

// The plan's round trip on `stream`: the launch into out_dev, the five rows
// into pinned host memory out_host, and one stream sync. Returns the first
// cudaError_t.
extern "C" int price_bundle_host(const double* price, const double* free,
                                 const double* dem_host, double gamma,
                                 double* out_dev, double* out_host, int WH,
                                 int R, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch(price, free, dem_host, gamma, out_dev, WH, R, vec, st);
  if (err) return err;
  err = (int)cudaMemcpyAsync(out_host, out_dev,
                             5 * (size_t)WH * sizeof(double),
                             cudaMemcpyDeviceToHost, st);
  if (err) return err;
  return (int)cudaStreamSynchronize(st);
}
