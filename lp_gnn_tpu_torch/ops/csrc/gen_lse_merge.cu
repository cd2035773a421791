// GEN softmax merge at the owners for Hopper (sm_90a), plain C interface
// (loaded with ctypes).
//
// The edge-partitioned GEN layer aggregates a variable's edges in parts:
// its owner's local edges, and the edges of other shards' constraint rows,
// each shard's in one compact halo slot. gen_agg_fwd gives each part its
// (aggr_p, lse_p) per channel, over its own edges. This kernel merges the
// parts of each owned variable into the softmax over all its edges:
//
//   lse  = log sum_p exp(lse_p)
//   aggr = sum_p exp(lse_p - lse) * aggr_p
//
// which is the single-card aggregation (lse is per segment and channel), up
// to rounding. A part with no edge (a variable without local edges: its
// aggr and lse are 0) has weight 0; a variable with no edge at all gets
// aggr 0 and lse 0, as gen_agg_fwd gives an empty segment.
//
// Replaces the owner-side combine of the JAX package's halo GEN layer
// (lp_gnn_tpu/parallel/edge_partition.py:880 _dist_gen_bidir_halo,
// :930-955): there a segment max is combined at the owners, sent back
// through the halo, and the exp-sums of every part are reduced at the
// owners. One merge of the parts' log-sum-exps gives the same softmax in
// one exchange of (aggr, lse) and no round trip.
//
// Inputs, for R = K*ns owner rows (stacked by shard) and D channels, fp32:
// local_edges (R) int32, the local part's edge count (0: no local part);
// loc_aggr, loc_lse (R, D), the local part; parts (P, ld) the received slot
// rows, aggr in columns [0, D) and lse in [D, 2D); ptr (R+1), idx (n)
// int32: row v's slot parts are parts[idx[ptr[v] .. ptr[v+1])], in a fixed
// order (the owner-side reduce CSR over the real slots). Outputs aggr, lse
// (R, D) fp32.
//
// One thread a (row, channel), neighbouring threads on neighbouring
// channels: an online update over the local part, then the slot parts in
// CSR order (a fixed order: two calls give the same bits), expf and logf in
// fp32. No atomics, no shared memory.
//
// Bound: bytes. The local parts and the outputs (4 x R x D x 4 bytes), the
// slot parts that reach a row (2 x n x D x 4) and the indices, over
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gen_lse_merge_kernel(const int* __restrict__ local_edges,
                     const float* __restrict__ loc_aggr,
                     const float* __restrict__ loc_lse,
                     const int* __restrict__ ptr, const int* __restrict__ idx,
                     const float* __restrict__ parts, long long ld, int rows,
                     int D, float* __restrict__ aggr, float* __restrict__ lse) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(rows) * D) return;
  const int v = static_cast<int>(i / D);
  const int c = static_cast<int>(i - static_cast<long long>(v) * D);
  float m = -INFINITY, s = 0.f, n = 0.f;
  if (__ldg(local_edges + v) > 0) {
    m = __ldg(loc_lse + i);
    s = 1.f;
    n = __ldg(loc_aggr + i);
  }
  const int end = __ldg(ptr + v + 1);
  for (int j = __ldg(ptr + v); j < end; ++j) {
    const float* p = parts + static_cast<long long>(__ldg(idx + j)) * ld;
    const float l = __ldg(p + D + c);
    const float a = __ldg(p + c);
    if (l > m) {  // rescale the running sums to the new max (0 at the start)
      const float f = expf(m - l);
      s = s * f + 1.f;
      n = n * f + a;
      m = l;
    } else {
      const float e = expf(l - m);
      s += e;
      n += e * a;
    }
  }
  if (s > 0.f) {
    aggr[i] = n / s;
    lse[i] = m + logf(s);
  } else {
    aggr[i] = 0.f;
    lse[i] = 0.f;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take; the caller
// raises on anything but 0.
extern "C" int lp_gen_lse_merge(const int* local_edges, const float* loc_aggr,
                                const float* loc_lse, const int* ptr, const int* idx,
                                const float* parts, long long ld, int rows, int D,
                                float* aggr, float* lse, void* stream) {
  if (rows < 0 || D < 1 || ld < 2LL * D) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(rows) * D;
  if (total == 0) return cudaSuccess;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gen_lse_merge_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      local_edges, loc_aggr, loc_lse, ptr, idx, parts, ld, rows, D, aggr, lse);
  return cudaGetLastError();
}
