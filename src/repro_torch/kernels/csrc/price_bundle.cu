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
// rate and nothing for the float64 units. The launch and the host copy of
// the result (this is the admission decision's sync point) dominate: the
// kernel is launch- and latency-bound, not bandwidth-bound. The design
// answers that by doing the whole plan's stack, all five rows, in ONE
// launch with ONE output buffer, so the wrapper makes one device-to-host
// copy per plan instead of W per-slot round trips.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ double nan_min(double m, double r) {
  // numpy's minimum: a NaN operand wins and stays
  return (r < m || isnan(r)) ? r : m;
}

__device__ __forceinline__ double headroom(const double* free_row,
                                           const double* dem, int R) {
  bool any = false;
  double m = INFINITY;
  for (int k = 0; k < R; ++k) {
    const double d = dem[k];
    if (d > 0.0) {
      any = true;
      m = nan_min(m, __ddiv_rn(free_row[k], d));
    }
  }
  if (!any) return INFINITY;
  // np.maximum(m, 0.0): keeps m when m >= 0 or m is NaN
  m = (m >= 0.0 || isnan(m)) ? m : 0.0;
  return floor(m);
}

__global__ void price_bundle_kernel(const double* __restrict__ price,
                                    const double* __restrict__ free,
                                    const double* __restrict__ dem,
                                    double* __restrict__ out, int WH, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WH) return;
  const double* wdem = dem;
  const double* sdem = dem + R;
  const double* coef = dem + 2 * R;
  const double* p = price + (size_t)i * R;
  double wp = 0.0, sp = 0.0, co = 0.0;
  for (int k = 0; k < R; ++k) {
    const double pk = p[k];
    const double a = wdem[k];
    const double b = sdem[k];
    if (a != 0.0) wp = __dadd_rn(wp, __dmul_rn(pk, a));
    if (b != 0.0) sp = __dadd_rn(sp, __dmul_rn(pk, b));
    co = __dadd_rn(co, __dmul_rn(pk, coef[k]));
  }
  const double* f = free + (size_t)i * R;
  out[i] = wp;
  out[(size_t)WH + i] = sp;
  out[2 * (size_t)WH + i] = co;
  out[3 * (size_t)WH + i] = headroom(f, wdem, R);
  out[4 * (size_t)WH + i] = headroom(f, sdem, R);
}

}  // namespace

// price, free: (WH, R) row-major float64; dem: (3, R) rows wdem, sdem, coef;
// out: (5, WH). Launches on `stream`; returns cudaGetLastError().
extern "C" int price_bundle_launch(const double* price, const double* free,
                                   const double* dem, double* out, int WH,
                                   int R, void* stream) {
  if (WH > 0) {
    const int threads = 128;
    const int blocks = (WH + threads - 1) / threads;
    price_bundle_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        price, free, dem, out, WH, R);
  }
  return (int)cudaGetLastError();
}
