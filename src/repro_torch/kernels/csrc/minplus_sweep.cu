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
// Exactness: values and choice are bit-identical to the plain version
// (minplus.py: minplus_step_torch) and so to k calls of the JAX package's
// scalar scan (minplus_scalar), 1e-12 hysteresis included, for tcost that
// holds no NaN and no -inf (a DP cost is finite or +inf). Two row solvers,
// picked by the width Q1:
//   * group (Q1 <= 128): row u is solved by a group of G lanes (a power
//     of two, G >= Q1 / 4), lane l holding the candidates v = l, l + G,
//     l + 2G, l + 3G in registers:
//       - val = __dadd_rn(prev[u-v], tcost[v]), +inf past the diagonal;
//       - the row min m is a min over the group, exact in any order;
//       - choice is the lowest v with val <= __dadd_rn(m, 1e-12) (ballot,
//         ffs); -1 when m is +inf;
//       - a row with any candidate in (m, __dadd_rn(m, 2e-12)] (the plain
//         version's replay predicate) is solved again by the scalar scan
//         below, run by every lane of its group on the same shared values;
//   * scan (Q1 > 128): lane u runs the scalar scan over its row, v = 0..u
//     in order, skipping +inf, accepting val < __dsub_rn(best, 1e-12).
// The file is built with --fmad=false; no product is formed anyway.
//
// What bounds it on the H100: at the main path's shape (k = 20, Q1 = 21) a
// sweep is about k*Q1^2/2 = 4.4k float64 adds over 3.4 KB of input, which
// the card does in far less than a launch costs. What is left is a chain of
// k dependent steps in one block on one SM, each at least a shared load, a
// shuffle reduction, a ballot and a barrier; measured, a step costs more in
// the instructions its warps execute than in those latencies, so the
// design keeps both short:
//   * no global memory on the chain: all of tcost is copied to shared
//     memory by cp.async, every copy in flight at once, before the loop, and
//     every row of C and choice stays there until one coalesced write at
//     the end, when the three tables fit (48 KB); else the running row and
//     its choices ping-pong between two shared buffers, row s goes out at
//     the start of step s + 1 (no store outstanding at a barrier), and
//     tcost streams through a ring of kRing rows fetched by cp.async a step
//     ahead, so k stays unbounded;
//   * one barrier a step;
//   * at Q1 = 21 a group is 8 lanes (3 shuffle rounds, 4 rows a warp, 6
//     warps), not a warp a row (5 rounds, 21 warps);
//   * C and choice share one output buffer (C first, then choice as
//     int64), which the host entry copies back with one copy and one
//     stream sync.
// The wrapper (minplus.py: sweep_layout) picks the solver, G, the warps
// and the ring; the entry re-checks them.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxQ1 = 1024;
constexpr int kGroupMaxQ1 = 128;            // wider rows take the scan
constexpr int kCand = 4;                    // candidates a group lane holds
static_assert(kCand == 4, "group_row's min tree takes four candidates");
constexpr int kRing = 2;                    // tcost rows in shared memory
constexpr size_t kSmemBudget = 48 * 1024;   // no opt-in attribute needed
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n doubles into shared memory by cp.async, neighbouring threads on
// neighbouring doubles, every copy in flight at once.
__device__ __forceinline__ void fetch(double* dst, const double* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async8(dst + i, src + i);
}

__device__ __forceinline__ double dmin(double a, double b) {
  return b < a ? b : a;
}

// The scalar reference's scan over row u.
__device__ __forceinline__ void scan_row(const double* prev, const double* tc,
                                         int u, double& best, int& bestv) {
  best = INFINITY;
  bestv = -1;
  for (int v = 0; v <= u; ++v) {
    const double val = __dadd_rn(prev[u - v], tc[v]);
    if (val == INFINITY) continue;
    if (val < __dsub_rn(best, 1e-12)) {
      best = val;
      bestv = v;
    }
  }
}

// Row u by a group of G lanes (gl: the lane's place in its group); every
// lane of the warp calls it, lanes of a group past the last row with
// live = false. Every lane of a group returns the row's value and choice.
template <int G>
__device__ __forceinline__ void group_row(const double* prev,
                                          const double* tc, int u, int gl,
                                          bool live, double& best,
                                          int& bestv) {
  double val[kCand];
#pragma unroll
  for (int c = 0; c < kCand; ++c) {
    const int v = c * G + gl;
    val[c] = live && v <= u ? __dadd_rn(prev[u - v], tc[v]) : INFINITY;
  }
  double m = dmin(dmin(val[0], val[1]), dmin(val[2], val[3]));
#pragma unroll
  for (int off = G / 2; off; off >>= 1) {
    m = dmin(m, __shfl_xor_sync(kFull, m, off));
  }
  const double hit_at = __dadd_rn(m, 1e-12);
  const double near_at = __dadd_rn(m, 2e-12);
  const int first_lane = (threadIdx.x & 31) & ~(G - 1);
  const unsigned gbits = G == 32 ? kFull : (1u << (G & 31)) - 1u;
  int first = -1;  // the lowest v within 1e-12: the lowest chunk wins
  bool near = false;
#pragma unroll
  for (int c = kCand - 1; c >= 0; --c) {
    const unsigned b =
        (__ballot_sync(kFull, val[c] <= hit_at) >> first_lane) & gbits;
    if (b) first = c * G + __ffs(b) - 1;
    near |= val[c] > m && val[c] <= near_at;
  }
  near = (__ballot_sync(kFull, near) >> first_lane) & gbits;
  if (m == INFINITY) {
    best = INFINITY;
    bestv = -1;
  } else if (!near) {
    best = m;
    bestv = first;
  } else {  // a near-tie: the scalar scan decides, as the plain version's
    scan_row(prev, tc, u, best, bestv);
  }
}

// G: lanes a row (1..32), or 0 for the scan, a lane a row. RING: tcost
// through a ring and the running row in two buffers; else all of tcost
// and every row of C and choice in shared memory.
template <int G, bool RING>
__global__ void minplus_sweep_kernel(const double* __restrict__ tcost,
                                     double* __restrict__ C,
                                     long long* __restrict__ choice, int k,
                                     int Q1) {
  extern __shared__ double sh[];
  // sh: rows of C (2, or k + 1), as many rows of choices (int), then
  // tcost (kRing rows, or k)
  const int rows = RING ? 2 : k + 1;
  int* chs = reinterpret_cast<int*>(sh + rows * Q1);
  double* tcs = sh + rows * Q1 + (rows * Q1 + 1) / 2;
  const int nthreads = blockDim.x;

  for (int i = threadIdx.x; i < Q1; i += nthreads) {
    sh[i] = i == 0 ? 0.0 : INFINITY;
    chs[i] = -1;
  }
  if constexpr (RING) {
    for (int r = 0; r < kRing - 1; ++r) {
      if (r < k) fetch(tcs + r * Q1, tcost + (size_t)r * Q1, Q1);
      cp_async_commit();
    }
    cp_async_wait<kRing - 2>();  // row 0 has landed
  } else {
    fetch(tcs, tcost, k * Q1);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    const int cur = RING ? (s & 1) : s;
    const int nxt = RING ? ((s + 1) & 1) : s + 1;
    const double* prev = sh + cur * Q1;
    double* next = sh + nxt * Q1;
    int* next_ch = chs + nxt * Q1;
    const double* tc;
    if constexpr (RING) {
      // row s out, coalesced; its buffer is not written before the next
      // barrier
      for (int i = threadIdx.x; i < Q1; i += nthreads) {
        C[(size_t)s * Q1 + i] = prev[i];
        choice[(size_t)s * Q1 + i] = chs[cur * Q1 + i];
      }
      // refill the slot that row s-1 held: every read of it finished
      // before the barrier that ended step s-1
      const int r = s + kRing - 1;
      if (r < k) {
        fetch(tcs + (r % kRing) * Q1, tcost + (size_t)r * Q1, Q1);
      }
      cp_async_commit();
      tc = tcs + (s % kRing) * Q1;
    } else {
      tc = tcs + s * Q1;
    }
    if constexpr (G == 0) {
      for (int u = threadIdx.x; u < Q1; u += nthreads) {
        double best;
        int bestv;
        scan_row(prev, tc, u, best, bestv);
        next[u] = best;
        next_ch[u] = bestv;
      }
    } else {
      constexpr int kRows = 32 / G;  // rows a warp takes at once
      const int lane = threadIdx.x & 31;
      const int gl = lane & (G - 1);
      const int stride = (nthreads >> 5) * kRows;
      for (int base = (threadIdx.x >> 5) * kRows; base < Q1; base += stride) {
        const int u = base + lane / G;
        const bool live = u < Q1;
        double best;
        int bestv;
        group_row<G>(prev, tc, u, gl, live, best, bestv);
        if (live && gl == 0) {
          next[u] = best;
          next_ch[u] = bestv;
        }
      }
    }
    if constexpr (RING) cp_async_wait<kRing - 2>();  // row s+1 has landed
    __syncthreads();
  }
  // what is still in shared memory goes out, coalesced: the last row, or
  // every row
  const int first_row = RING ? k : 0;
  const int n = (k + 1 - first_row) * Q1;
  const int off = RING ? (k & 1) * Q1 : 0;
  for (int i = threadIdx.x; i < n; i += nthreads) {
    C[(size_t)first_row * Q1 + i] = sh[off + i];
    choice[(size_t)first_row * Q1 + i] = chs[off + i];
  }
}

// Shared memory for `rows` rows of C and of choices and `tc_rows` rows of
// tcost, in bytes.
size_t smem_bytes(int rows, int tc_rows, int Q1) {
  const size_t cells = (size_t)rows * Q1;
  return (cells + (cells + 1) / 2 + (size_t)tc_rows * Q1) * sizeof(double);
}

// The layout sweep_layout picks, recomputed: lanes a row (0: the scan),
// warps, and the ring exactly when the whole tables do not fit.
bool layout_ok(int k, int Q1, int lanes, int warps, int ring, size_t* smem) {
  if (k < 0 || Q1 < 1 || Q1 > kMaxQ1) return false;
  int want_lanes = 0, want_warps = (Q1 + 31) / 32;
  if (Q1 <= kGroupMaxQ1) {
    want_lanes = 1;
    while (want_lanes * kCand < Q1) want_lanes *= 2;
    const int rows = 32 / want_lanes;
    want_warps = (Q1 + rows - 1) / rows;
    if (want_warps > 32) want_warps = 32;
  }
  if (lanes != want_lanes || warps != want_warps) return false;
  const size_t whole = smem_bytes(k + 1, k, Q1);
  const bool fits = whole <= kSmemBudget;
  if ((ring != 0) == fits) return false;
  *smem = fits ? whole : smem_bytes(2, kRing, Q1);
  return *smem <= kSmemBudget;
}

template <int G>
void launch_g(const double* tcost, double* C, long long* choice, int k,
              int Q1, int warps, int ring, size_t smem, cudaStream_t stream) {
  if (ring) {
    minplus_sweep_kernel<G, true>
        <<<1, warps * 32, smem, stream>>>(tcost, C, choice, k, Q1);
  } else {
    minplus_sweep_kernel<G, false>
        <<<1, warps * 32, smem, stream>>>(tcost, C, choice, k, Q1);
  }
}

int launch(const double* tcost, double* out, int k, int Q1, int lanes,
           int warps, int ring, cudaStream_t stream) {
  size_t smem = 0;
  if (!layout_ok(k, Q1, lanes, warps, ring, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  double* C = out;
  long long* choice = reinterpret_cast<long long*>(out + (size_t)(k + 1) * Q1);
  switch (lanes) {
    case 0: launch_g<0>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    case 1: launch_g<1>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    case 2: launch_g<2>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    case 4: launch_g<4>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    case 8: launch_g<8>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    case 16: launch_g<16>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
    default: launch_g<32>(tcost, C, choice, k, Q1, warps, ring, smem, stream); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tcost: (k, Q1) row-major float64 on the device; out: 2 (k+1) Q1 doubles
// on the device, C (k+1, Q1) float64 then choice (k+1, Q1) int64. One block
// of `warps` warps; `lanes` (0 for the scan) and `ring` as sweep_layout
// chose them. Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for a layout it does not take).
extern "C" int minplus_sweep_launch(const double* tcost, double* out, int k,
                                    int Q1, int lanes, int warps, int ring,
                                    void* stream) {
  return launch(tcost, out, k, Q1, lanes, warps, ring, (cudaStream_t)stream);
}

// The DP's whole round trip on `stream`: tcost from pinned host memory to
// the device, the launch, the tables back into pinned host memory, and one
// stream sync. Returns the first cudaError_t.
extern "C" int minplus_sweep_host(const double* tcost_host, double* tcost_dev,
                                  double* out_dev, double* out_host, int k,
                                  int Q1, int lanes, int warps, int ring,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t in_bytes = (size_t)k * Q1 * sizeof(double);
  const size_t out_bytes = 2 * (size_t)(k + 1) * Q1 * sizeof(double);
  int err = (int)cudaMemcpyAsync(tcost_dev, tcost_host, in_bytes,
                                 cudaMemcpyHostToDevice, st);
  if (err) return err;
  err = launch(tcost_dev, out_dev, k, Q1, lanes, warps, ring, st);
  if (err) return err;
  err = (int)cudaMemcpyAsync(out_host, out_dev, out_bytes,
                             cudaMemcpyDeviceToHost, st);
  if (err) return err;
  return (int)cudaStreamSynchronize(st);
}
