// The whole Algorithm 3 min-plus DP sweep in one launch.
//
// Replaces the TPU kernel src/repro/kernels/minplus.py::_pallas_minplus_call,
// which ran ONE tropical vector-matrix step cur[u] = min_v A[u,v] + b[v]
// per launch in float32, on a Toeplitz operand A[u,v] = prev[u-v] that the
// host built in O(Q^2), with the backtracking choice recovered on the host
// by a plain argmin. Here the k steps of a sweep run in one block:
//
//   C[0]   = [0, inf, ..., inf],  choice[0] = -1
//   C[s+1][u] = min_{0 <= v <= u} C[s][u-v] + tcost[s][v]
//
// Exactness: thread u runs the scalar reference's scan (minplus_scalar in
// the JAX package): v = 0..u in order, skipping +inf operands, accepting
// val = __dadd_rn(prev[u-v], tcost[v]) only when val < __dsub_rn(best,
// 1e-12). Values and choice are therefore bit-identical to k calls of the
// scalar loop, including its 1e-12 hysteresis on near-ties. The Toeplitz
// operand is never built: it is indexed from the previous row.
//
// What bounds it on the H100: at the main path's shape (k <= 20, Q+1 = 21)
// a sweep is about k*Q1^2/2 = 4.4k float64 adds over 3.4 KB of input, which
// the card does in far less than a launch costs. It is launch- and
// latency-bound (a dependent chain of k steps, each a barrier), not
// bandwidth-bound. The design answers that by fusing the sweep: one launch
// per DP instead of one per slot, with the running row and the current
// tcost row in shared memory and the tables written straight to their
// outputs, so the host makes one copy per table per sweep.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void minplus_sweep_kernel(const double* __restrict__ tcost,
                                     double* __restrict__ C,
                                     long long* __restrict__ choice, int k,
                                     int Q1) {
  extern __shared__ double sh[];
  double* prev = sh;       // C[s], the running row
  double* tc = sh + Q1;    // tcost[s]
  const int u = threadIdx.x;
  const bool live = u < Q1;
  if (live) {
    const double c0 = (u == 0) ? 0.0 : INFINITY;
    prev[u] = c0;
    C[u] = c0;
    choice[u] = -1;
  }
  for (int s = 0; s < k; ++s) {
    if (live) tc[u] = tcost[(size_t)s * Q1 + u];
    __syncthreads();
    double best = INFINITY;
    long long bestv = -1;
    if (live) {
      for (int v = 0; v <= u; ++v) {
        const double pu = prev[u - v];
        const double t = tc[v];
        if (pu == INFINITY || t == INFINITY) continue;
        const double val = __dadd_rn(pu, t);
        if (val < __dsub_rn(best, 1e-12)) {
          best = val;
          bestv = v;
        }
      }
    }
    __syncthreads();  // every read of prev/tc is done before they change
    if (live) {
      prev[u] = best;
      C[(size_t)(s + 1) * Q1 + u] = best;
      choice[(size_t)(s + 1) * Q1 + u] = bestv;
    }
  }
}

}  // namespace

// tcost: (k, Q1) row-major float64; C: (k+1, Q1) float64; choice: (k+1, Q1)
// int64. One block of Q1 threads (Q1 <= 1024, checked by the caller).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int minplus_sweep_launch(const double* tcost, double* C,
                                    long long* choice, int k, int Q1,
                                    void* stream) {
  const int threads = ((Q1 + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)Q1 * sizeof(double);
  minplus_sweep_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      tcost, C, choice, k, Q1);
  return (int)cudaGetLastError();
}
