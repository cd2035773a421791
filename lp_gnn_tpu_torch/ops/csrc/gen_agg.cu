// GEN softmax aggregation for Hopper (sm_90a), forward and backward, plain C
// interface (loaded with ctypes).
//
// Over one GEN direction, an edge ordering sorted by destination (ptr
// (num_dst+1), src (E), a (E) fp32), with x (S, D) and the edge encoder
// w, b (D) and temperature t (a 0-d tensor), all of x's type T:
//
//   pre[e, c] = x[src[e], c] + a_T[e] * w[c] + b[c]      (a_T: a rounded to T)
//   m[e, c]   = relu(pre[e, c]) + 1e-7
//   alpha     = softmax over the edges of a segment of t * m   (per channel)
//   aggr[d,c] = sum over segment d of alpha * m                (0 if empty)
//
// Replaces the GEN message and aggregation of the JAX package:
// lp_gnn_tpu/models/gen.py:136-145 gen_dir_apply (edge encoder, the gather
// through lp_gnn_tpu/ops/spmm.py:252 gather_src, relu + eps, t) and
// :39-106 _segment_softmax_agg in its default mode (a per-segment max; its
// empty-segment guards give 0). XLA lowers those as separate passes over
// (E, D) edge tensors; here the forward is one pass with no (E, D) tensor
// in device memory.
//
// gen_agg_fwd_kernel: an online softmax per segment and channel, in base 2
// (running max M of z = t log2(e) m, S the sum of 2^(z - M), N the sum of
// 2^(z - M) m, fp32), writing aggr = N / S and, unless its pointer is null
// (no gradient will be taken), lse = ln 2 (M + log2 S) (fp32, num_dst x D).
//
// gen_agg_bwd_kernel: per edge it recomputes m and alpha = exp(t m - lse)
// and, with g = dL/daggr, writes
//   dpre = g alpha (1 + t (m - aggr)) [pre > 0]
// in x's type, into rows of stride ld >= D (the caller zero-fills the
// padding, so that the CSR SpMM can read the rows: the gather's backward is
// csrc/spmm.cu over the transpose ordering, not a kernel here). Each CTA
// also writes its partial sums of a_T dpre (dw), dpre (db) and
// g alpha m (m - aggr) (dt, in fp64) into one row of a workspace, and
// gen_agg_reduce_kernel adds the rows in CTA order. No float atomics: two
// calls give the same bits.
//
// Bound. Bytes: ptr, src and a read once, the rows of x that some edge
// references, aggr and lse written (forward: 0.063 ms at the bench graph's
// v2c, D=256 bf16, 3.35 TB/s); g, aggr and lse read and dpre written
// (backward: 0.235 ms). Issue: the forward's chunk loop (bf16, 2 edges x 8
// channels a lane) executes about 330 SASS instructions a chunk by
// cuobjdump -sass, about 20 a (edge, channel): the message 5 (a w, + b,
// + x, relu, the chunk's max), the softmax 4 (the exponent's fma, ex2, two
// sums), the chunk's rescale 3.5, the bf16 unpack 1, the rest the loop,
// the chunk copy and the gathers' addresses. At one instruction a lane a
// clock (132 SMs x 128 lanes x 1.98 GHz) the E x D = 268M elements of the
// bench graph take 0.165 ms to issue: the forward is bound by instructions,
// 2.6x its bytes (an earlier note here had the arithmetic far below the
// card's fp32 rate; it is not). The backward's loop ran about 22 an
// element (0.178 ms, under its bytes) with alpha in base 2; alpha by expf
// and dt's compensated terms (item 6) add to that, not recounted.
//
// Design against those bounds:
// 1. Edge-balanced CTAs. The work is cut by a merge path over
//    f(r) = r + ptr[r], as csrc/spmm.cu cuts rows (its 32-ary search):
//    segment r takes the units r + ptr[r] .. r + ptr[r+1] (its edges, then
//    one for its end), and CTA c the units [c U / grid, (c+1) U / grid), U =
//    num_dst + E, so every CTA holds about equal edges and segments. A
//    segment that spans several CTAs is split: each holds a part. In the
//    forward each part's (M, S, N) goes to a slot of the caller's workspace
//    and the last CTA to arrive (an atomic count, in a workspace of its own,
//    handed back zeroed) merges the slots in CTA order; in the backward
//    every edge's dpre needs only its segment's g, aggr and lse, so a part
//    needs no merge. One launch either way, and fixed orders.
// 2. Staged edge stream. Each CTA copies its (src, a) range and its
//    segments' first edges, clamped to its range, into shared memory with
//    cp.async (at most kStage units a CTA), so the chain for a segment is
//    one global load, its x rows. The rows in flight stay in registers
//    (item 4): a ring of each lane's next three 16-byte pieces in shared
//    memory, filled by cp.async across a team's segments, freed 13 of the
//    bf16 forward's 128 registers but not a third CTA an SM, and measured
//    slower on the bench graph (8% at 2 CTAs an SM, 33% at 3 with spills).
// 3. L2 policy. Gathers of x carry evict_last, the edge stream
//    evict_first, and aggr, lse and dpre are stored with the streaming hint.
//    A slab is one piece a lane of a warp (32 pieces, 16 bytes each: a whole
//    row at D=256 bf16): slabs narrow enough that x fits the L2 (16 or 8
//    pieces at the bench graph's v2c, where x is 67 MB) measured slower,
//    each repeating the walk of the edge stream.
// 4. Fewer instructions an element. The softmax is in base 2
//    (ex2.approx.ftz, t log2(e) folded once). A chunk of edges takes its max
//    first (z is monotonic in relu(pre), so the max comes from the chunk's
//    largest relu, its least where t < 0), rescales the sums once, and adds
//    2^(z - M) of each edge with no select; eps is added to aggr at the end
//    (the weights sum to 1) rather than to each message. bf16 unpacks by a
//    shift or a mask, and aggr takes a reciprocal, with no slow path. The
//    backward does not: its alpha is exp(t m - lse) by expf with the plain
//    version's roundings, so that dt's terms are the plain version's (with
//    ex2.approx, dt missed its fp32 limit, 1e-5 (|dt| + 1), by 29% on a
//    test case whose terms cancel to |dt| = 0.47).
//    Chunks are 2 edges where a lane holds 8 channels (bf16 pieces), 4 else,
//    which measured fastest; for bf16 the forward issues the next chunk's
//    gathers before the current chunk's arithmetic.
// 5. Teams. A team of G lanes (G a power of two, <= 32) takes one segment;
//    lane l holds one piece of VEC channels (16 bytes where D allows it, else
//    one channel). A CTA's segments (its parts of split ones) go to teams in
//    turn; those with more than kLongSeg edges in the CTA are taken by the
//    whole CTA, team j on chunks j, j + teams, ..., the forward's teams'
//    triples merged through shared memory in team order.
// 6. Sums. dw and db accumulate a lane, then the teams in order, then the
//    CTAs in order in gen_agg_reduce_kernel, with compensated sums over the
//    thousand CTAs a bench-graph grid has. dt, whose terms cancel, adds each
//    term to a lane's compensated fp32 sum; from there it is fp64: a shuffle
//    tree a warp, the warps in order, an fp64 slot of the CTA's row, the
//    CTAs in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 1024;     // merge-path units (edges + segments) a CTA at most
constexpr int kLongSeg = 64;     // a longer part of a segment is taken by the whole CTA
constexpr int kMaxLong = kStage / kLongSeg;
// edges of a chunk (in flight a team, one max): 2 where a lane holds 8
// channels (bf16 pieces), 4 where it holds 4 or fewer, which measured
// fastest
template <int VEC> constexpr int kU = VEC >= 8 ? 2 : 4;
// the forward keeps the next chunk's gathers in flight where a lane holds 8
// channels (bf16 pieces); with 4 or fewer the copies cost more registers
// than the overlap gains
template <int VEC> constexpr bool kPrefetch = VEC >= 8;
constexpr int kMinCtas = 2;      // CTAs an SM the register budget is set for
constexpr int kMaxSlab = 32;     // pieces of a slab: one a lane
constexpr int kMinUnits = 64;    // least merge-path units worth a CTA
constexpr float kEps = 1e-7f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// A 16-byte read-only load under an L2 policy.
__device__ __forceinline__ uint4 ld16(const void* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, uint64_t pol) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "l"(pol) : "memory");
}

// A source row's piece as loaded: one 16-byte load where VEC * sizeof(T)
// is 16 (the row then 16-byte aligned), else VEC elements.
template <typename T, int VEC, bool kWide = VEC * sizeof(T) == 16>
struct Raw {
  T v[VEC];
};
template <typename T, int VEC>
struct Raw<T, VEC, true> {
  uint4 u;
};

template <typename T, int VEC>
__device__ __forceinline__ void fetch(const T* __restrict__ p, uint64_t pol, Raw<T, VEC>& r) {
  if constexpr (VEC * sizeof(T) == 16) {
    r.u = ld16(p, pol);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = __ldg(p + k);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 4) {
    v[0] = __uint_as_float(r.u.x);
    v[1] = __uint_as_float(r.u.y);
    v[2] = __uint_as_float(r.u.z);
    v[3] = __uint_as_float(r.u.w);
  } else if constexpr (VEC * sizeof(T) == 16) {   // a bf16 is the top half of its fp32
    const uint32_t h[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      v[2 * i] = __uint_as_float(h[i] << 16);
      v[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_f<T>(r.v[k]);
  }
}

// VEC elements of T at p as fp32, read under the policy.
template <typename T, int VEC>
__device__ __forceinline__ void load_piece(const T* __restrict__ p, uint64_t pol,
                                           float (&v)[VEC]) {
  Raw<T, VEC> r;
  fetch<T, VEC>(p, pol, r);
  unpack<T, VEC>(r, v);
}

// VEC values rounded to T at p, with the streaming hint where they make one
// 16-byte piece.
template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    if constexpr (sizeof(T) == 4) {
      u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_f<T>(v[k]);
  }
}

// VEC fp32 values: float4 pieces where VEC is a multiple of 4 (p then
// 16-byte aligned), else one by one; loads read-only, stores streaming.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __ldg(p + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      __stcs(reinterpret_cast<float4*>(p + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) __stcs(p + k, v[k]);
  }
}


// The first segment r in [0, n] with r + ptr[r] >= t (n when there is none),
// by one warp: 32 probes a step cut the interval 33-fold (csrc/spmm.cu's
// search). Also returns ptr[r], read by the probe that found it.
__device__ int2 merge_path_row(const int* __restrict__ ptr, int n, long long t, int lane) {
  int lo = 0, hi = n;
  int ptr_hi = __ldg(ptr + n);
  while (lo < hi) {
    const int q = lo + static_cast<int>(static_cast<long long>(hi - lo) * (lane + 1) / 33);
    const int pq = __ldg(ptr + q);
    const bool ge = static_cast<long long>(q) + pq >= t;
    const unsigned below = ~__ballot_sync(0xffffffffu, ge);
    const int k = __popc(below);
    const int q_lo = __shfl_sync(0xffffffffu, q, k > 0 ? k - 1 : 0);
    const int q_hi = __shfl_sync(0xffffffffu, q, k < 32 ? k : 31);
    const int p_hi = __shfl_sync(0xffffffffu, pq, k < 32 ? k : 31);
    if (k > 0) lo = q_lo + 1;
    if (k < 32) {
      hi = q_hi;
      ptr_hi = p_hi;
    }
  }
  return make_int2(lo, ptr_hi);
}

struct Plan {
  int num_dst;
  int D;
  int pieces;       // pieces of a row: D / VEC
  int slab;         // pieces of a slab (<= kMaxSlab)
  int n_slabs;
  int g_log;        // log2 G: lanes of a team (G >= slab)
  int ld;           // row stride of dpre (backward)
  long long units;  // num_dst + E: the merge path's length
};

// The caller's workspace. Forward: count[c] counts the arrivals at the split
// segment whose first CTA is c (0 again when the kernel ends); tri holds
// two slots of (M, S, N) x D fp32 a CTA: slot 2c+1 its share of the
// segment it ends on, slot 2c of the one it starts in. Backward: part, one
// row a CTA: dw and db (2D fp32), then dt (one fp64).
struct Work {
  int* count;
  float* tri;
  float* part;
};

// The CTA of merge-path unit d: target(c) = c * units / grid <= d < target(c+1).
__device__ __forceinline__ int cta_of(long long d, long long units, int grid) {
  return static_cast<int>(((d + 1) * grid - 1) / units);
}

// A CTA's share of the merge path over f(r) = r + ptr[r]: segment r takes
// the units r + ptr[r] .. r + ptr[r+1] (its edges, then one for its end), so
// CTA c, with units [d0, d1), holds the edges [j0, j0 + ne) and the
// segments [r_lo, r_lo + nr) that have a unit there. A segment split across
// CTAs is the first or the last of each CTA's segments.
struct Range {
  int r_lo, nr, j0, ne;
  int split_lo;   // first CTA of segment r_lo if it began before d0, else -1
  int split_hi;   // last CTA of segment r_lo + nr - 1 if it runs past d1, else -1
};

// The staged edge stream of a CTA: src and a of its edges, and each of its
// segments' first edge, clamped to the CTA's edges and counted from j0; the
// segments with more than kLongSeg of them, in order.
struct Stage {
  int src[kStage];
  float a[kStage];
  int ptr[kStage + 2];
  int lng[kMaxLong + 1];
  int n_long;
  int r[6];
};

// Finds the CTA's range (warps 0-2 search) and stages its edge stream with
// cp.async (evict_first). Every thread calls it; it ends with a barrier.
__device__ Range stage_cta(const int* __restrict__ ptr, const int* __restrict__ src,
                           const float* __restrict__ a, const Plan& p, Stage& st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grid = gridDim.x, cta = blockIdx.x;
  const long long d0 = cta * p.units / grid, d1 = (cta + 1) * p.units / grid;
  const bool last = cta + 1 == grid;
  if (warp == 0 && cta > 0) {
    const int2 q = merge_path_row(ptr, p.num_dst, d0 + 1, lane);  // r_lo + 1
    if (lane == 0) st.r[0] = q.x - 1;
  }
  if (warp == 1 && !last) {
    const int2 q = merge_path_row(ptr, p.num_dst, d1 + 1, lane);  // the next CTA's r_lo + 1
    if (lane == 0) st.r[1] = q.x - 1;
  }
  if (warp == 2 && !last) {
    const int2 q = merge_path_row(ptr, p.num_dst, d1, lane);      // past the last segment
    if (lane == 0) {
      st.r[2] = q.x;
      st.r[3] = q.y;
    }
  }
  if (threadIdx.x == 0) {
    if (cta == 0) st.r[0] = 0;
    if (last) {
      st.r[2] = p.num_dst;
      st.r[3] = __ldg(ptr + p.num_dst);
    }
  }
  __syncthreads();
  Range rg;
  rg.r_lo = st.r[0];
  const int r_hi = st.r[2];
  rg.nr = r_hi - rg.r_lo;
  rg.j0 = cta == 0 ? 0 : static_cast<int>(d0 - rg.r_lo);
  const int j1 = last ? st.r[3] : static_cast<int>(d1 - st.r[1]);
  rg.ne = j1 - rg.j0;
  rg.split_lo = -1;
  rg.split_hi = -1;
  if (rg.nr > 0) {
    const long long f_lo = rg.r_lo + static_cast<long long>(__ldg(ptr + rg.r_lo));
    if (f_lo < d0) rg.split_lo = cta_of(f_lo, p.units, grid);
    const long long e_hi = r_hi - 1 + static_cast<long long>(st.r[3]);
    if (!last && e_hi >= d1) rg.split_hi = cta_of(e_hi, p.units, grid);
  }
  const uint64_t first = policy_evict_first();
  for (int i = threadIdx.x; i < rg.ne; i += kThreads) {
    cp_async4(st.src + i, src + rg.j0 + i, first);
    cp_async4(st.a + i, a + rg.j0 + i, first);
  }
  for (int k = threadIdx.x; k <= rg.nr; k += kThreads)
    st.ptr[k] = min(max(__ldg(ptr + rg.r_lo + k), rg.j0), j1) - rg.j0;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // the long segments in order: warp 0 compacts the ballots of 32 at a time
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < rg.nr; base += 32) {
      const int k = base + lane;
      const bool lg = k < rg.nr && st.ptr[k + 1] - st.ptr[k] > kLongSeg;
      const unsigned m = __ballot_sync(0xffffffffu, lg);
      if (lg) st.lng[n + __popc(m & ((1u << lane) - 1))] = k;
      n += __popc(m);
    }
    if (lane == 0) st.n_long = n;
  }
  __syncthreads();
  return rg;
}

// One lane's view of a direction: its piece of VEC channels, with the edge
// encoder's weights there and the temperature, in fp32.
template <typename T, int VEC>
struct Lane {
  const T* __restrict__ x;
  int D;
  int c0;         // first channel of the lane's piece
  bool on;        // the piece lies inside the row and the slab
  float t, t2;    // the temperature, and t log2(e): the softmax in base 2
  float t2e;      // t2 eps
  uint64_t keep;  // evict_last: the gathers of x
  float w[VEC], b[VEC];

  // The pre-activation of channel c0 + k of an edge with a_T = ae whose
  // source row's piece is xv: x + (a w + b), each operation rounded (no
  // fused multiply-add), so that the plain versions' fp32 arithmetic gives
  // the same bits and the relu mask of the backward is theirs.
  __device__ __forceinline__ float pre_of(const float (&xv)[VEC], float ae, int k) const {
    return __fadd_rn(xv[k], __fadd_rn(__fmul_rn(ae, w[k]), b[k]));
  }
};

// A chunk of up to kU staged edges as loaded: n of them, the source rows'
// pieces (evict_last) and each edge's a.
template <typename T, int VEC>
struct Chunk {
  Raw<T, VEC> x[kU<VEC>];
  float a[kU<VEC>];
  int n;
};

template <typename T, int VEC>
__device__ __forceinline__ void fetch_chunk(const Lane<T, VEC>& L, const Stage& st, int e,
                                            int e_end, Chunk<T, VEC>& c) {
  c.n = min(kU<VEC>, e_end - e);
#pragma unroll
  for (int u = 0; u < kU<VEC>; ++u) {
    if (u < c.n) {
      c.a[u] = st.a[e + u];
      fetch<T, VEC>(L.x + static_cast<size_t>(st.src[e + u]) * L.D + L.c0, L.keep, c.x[u]);
    }
  }
}

// A chunk's pieces in fp32 into v and a_T of each edge into av.
template <typename T, int VEC>
__device__ __forceinline__ void unpack_chunk(const Chunk<T, VEC>& c, float (&v)[kU<VEC>][VEC],
                                             float (&av)[kU<VEC>]) {
#pragma unroll
  for (int u = 0; u < kU<VEC>; ++u) {
    if (u < c.n) {
      av[u] = to_f<T>(from_f<T>(c.a[u]));
      unpack<T, VEC>(c.x[u], v[u]);
    }
  }
}

// The same gathers straight into fp32 (no chunk in flight): returns n.
template <typename T, int VEC>
__device__ __forceinline__ int gather_pieces(const Lane<T, VEC>& L, const Stage& st, int e,
                                             int e_end, float (&v)[kU<VEC>][VEC],
                                             float (&av)[kU<VEC>]) {
  const int n = min(kU<VEC>, e_end - e);
#pragma unroll
  for (int u = 0; u < kU<VEC>; ++u) {
    if (u < n) {
      av[u] = to_f<T>(from_f<T>(st.a[e + u]));
      load_piece<T, VEC>(L.x + static_cast<size_t>(st.src[e + u]) * L.D + L.c0, L.keep, v[u]);
    }
  }
  return n;
}

// The online softmax in base 2 over chunks of kU edges [e, e + kU)
// clipped to e_end, e += step, into the running (M, S, N) of each channel,
// over r = relu(pre): z = t2 (r + eps) is taken as fma(t2, r, t2 eps), and
// N sums 2^(z - M) r, the eps added at the end (the weights sum to 1).
// Each chunk takes its max first: z is monotonic in r, so the max of z
// comes from the chunk's max r (its min where t < 0, one branch a chunk);
// then one rescale of the sums, and 2^(z - M) of each edge added with no
// select.
template <typename T, int VEC>
__device__ __forceinline__ void fwd_edges(const Lane<T, VEC>& L, const Stage& st, int e,
                                          int e_end, int step, float (&M)[VEC],
                                          float (&S)[VEC], float (&N)[VEC]) {
  if (!L.on || e >= e_end) return;
  const bool up = L.t2 >= 0.f;
  Chunk<T, VEC> next;
  if constexpr (kPrefetch<VEC>) fetch_chunk<T, VEC>(L, st, e, e_end, next);
  for (; e < e_end; e += step) {
    float v[kU<VEC>][VEC];
    float av[kU<VEC>];
    int n;
    if constexpr (kPrefetch<VEC>) {
      // the next chunk's gathers go out before this chunk's arithmetic
      const Chunk<T, VEC> cur = next;
      if (e + step < e_end) fetch_chunk<T, VEC>(L, st, e + step, e_end, next);
      unpack_chunk<T, VEC>(cur, v, av);
      n = cur.n;
    } else {
      n = gather_pieces<T, VEC>(L, st, e, e_end, v, av);
    }
    float cr[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) cr[k] = up ? 0.f : INFINITY;
    if (up) {
#pragma unroll
      for (int u = 0; u < kU<VEC>; ++u) {
        if (u < n) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[u][k] = fmaxf(L.pre_of(v[u], av[u], k), 0.f);
            cr[k] = fmaxf(cr[k], v[u][k]);
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU<VEC>; ++u) {
        if (u < n) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[u][k] = fmaxf(L.pre_of(v[u], av[u], k), 0.f);
            cr[k] = fminf(cr[k], v[u][k]);
          }
        }
      }
    }
    float c[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float mn = fmaxf(M[k], fmaf(L.t2, cr[k], L.t2e));
      const float sc = ex2(M[k] - mn);   // 0 while M is -inf
      S[k] *= sc;
      N[k] *= sc;
      M[k] = mn;
      c[k] = L.t2e - mn;
    }
#pragma unroll
    for (int u = 0; u < kU<VEC>; ++u) {
      if (u < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float pe = ex2(fmaf(L.t2, v[u][k], c[k]));
          S[k] += pe;
          N[k] = fmaf(pe, v[u][k], N[k]);
        }
      }
    }
  }
}

// (M, S, N) += (m2, s2, n2): the kernel's rule for two parts of a segment.
__device__ __forceinline__ void merge3(float& M, float& S, float& N, float m2, float s2,
                                       float n2) {
  if (s2 == 0.f) return;   // an empty part
  const float mn = fmaxf(M, m2);
  const float fa = ex2(M - mn), fb = ex2(m2 - mn);
  S = fmaf(S, fa, s2 * fb);
  N = fmaf(N, fa, n2 * fb);
  M = mn;
}

// aggr = N / S + eps (N times the correctly rounded 1 / S: no slow path)
// and lse = ln 2 (M + log2 S), 0 for an empty segment.
__device__ __forceinline__ void fwd_value(float M, float S, float N, float& va, float& vl) {
  const bool any = S > 0.f;
  va = any ? fmaf(N, __frcp_rn(S), kEps) : 0.f;
  vl = any ? kLn2 * (M + lg2(S)) : 0.f;
}

template <int VEC>
__device__ __forceinline__ void store_cg(float* __restrict__ p, const float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) __stcg(p + k, v[k]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
gen_agg_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                   const float* __restrict__ a, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ b,
                   const T* __restrict__ tp, float* __restrict__ aggr,
                   float* __restrict__ lse, const Plan p, const Work wk) {
  __shared__ Stage st;
  __shared__ float s_m[kThreads * VEC];
  __shared__ float s_s[kThreads * VEC];
  __shared__ float s_n[kThreads * VEC];
  __shared__ int s_last;
  const Range rg = stage_cta(ptr, src, a, p, st);
  if (rg.nr <= 0) return;
  const int cta = blockIdx.x;
  const int D = p.D;
  const int team = threadIdx.x >> p.g_log;
  const int gl = threadIdx.x & ((1 << p.g_log) - 1);
  const int teams = kThreads >> p.g_log;
  Lane<T, VEC> L;
  L.x = x;
  L.D = D;
  L.t = to_f<T>(*tp);
  L.t2 = L.t * kLog2e;
  L.t2e = L.t2 * kEps;
  L.keep = policy_evict_last();

  // segment k's values: written out, or its part's triple into the slot of
  // a split segment
  auto finish = [&](int k, const float (&M)[VEC], const float (&S)[VEC],
                    const float (&N)[VEC]) {
    const int slot = k == 0 && rg.split_lo >= 0            ? 2 * cta
                     : k == rg.nr - 1 && rg.split_hi >= 0 ? 2 * cta + 1
                                                          : -1;
    if (slot < 0) {
      float va[VEC], vl[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) fwd_value(M[i], S[i], N[i], va[i], vl[i]);
      const size_t row = static_cast<size_t>(rg.r_lo + k) * D + L.c0;
      store_f32<VEC>(aggr + row, va);
      if (lse != nullptr) store_f32<VEC>(lse + row, vl);
    } else {
      float* t = wk.tri + static_cast<size_t>(slot) * 3 * D + L.c0;
      store_cg<VEC>(t, M);
      store_cg<VEC>(t + D, S);
      store_cg<VEC>(t + 2 * D, N);
    }
  };

  for (int s = 0; s < p.n_slabs; ++s) {
    const int piece = s * p.slab + gl;
    L.on = gl < p.slab && piece < p.pieces;
    L.c0 = piece * VEC;
    if (L.on) {
      load_piece<T, VEC>(w + L.c0, L.keep, L.w);
      load_piece<T, VEC>(b + L.c0, L.keep, L.b);
    }
    // short segments: one a team
    for (int k = team; k < rg.nr; k += teams) {
      const int e0 = st.ptr[k], e1 = st.ptr[k + 1];
      if (e1 - e0 > kLongSeg) continue;
      float M[VEC], S[VEC], N[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        M[i] = -INFINITY;
        S[i] = 0.f;
        N[i] = 0.f;
      }
      fwd_edges<T, VEC>(L, st, e0, e1, kU<VEC>, M, S, N);
      if (L.on) finish(k, M, S, N);
    }
    // long ones: the whole CTA on each, team j on chunks j, j + teams, ...,
    // the teams' triples merged in team order
    for (int i = 0; i < st.n_long; ++i) {
      const int k = st.lng[i];
      float M[VEC], S[VEC], N[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        M[c] = -INFINITY;
        S[c] = 0.f;
        N[c] = 0.f;
      }
      fwd_edges<T, VEC>(L, st, st.ptr[k] + team * kU<VEC>, st.ptr[k + 1], teams * kU<VEC>, M,
                        S, N);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        s_m[threadIdx.x * VEC + c] = M[c];
        s_s[threadIdx.x * VEC + c] = S[c];
        s_n[threadIdx.x * VEC + c] = N[c];
      }
      __syncthreads();
      if (team == 0 && L.on) {
        for (int j = 1; j < teams; ++j) {
          const int q = ((j << p.g_log) + gl) * VEC;
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            merge3(M[c], S[c], N[c], s_m[q + c], s_s[q + c], s_n[q + c]);
        }
        finish(k, M, S, N);
      }
      __syncthreads();
    }
  }

  // a split segment: the last of its CTAs to arrive merges the parts in CTA
  // order (slot 2 c_a + 1, then slot 2c of each later CTA c)
  auto arrive = [&](int c_a, int c_b, int r) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(wk.count + c_a, 1) == c_b - c_a;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    constexpr int kBatch = 8;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float M = -INFINITY, S = 0.f, N = 0.f;
      for (int q0 = c_a; q0 <= c_b; q0 += kBatch) {
        float pm[kBatch], ps[kBatch], pn[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + u;
          ps[u] = 0.f;
          if (q <= c_b) {
            const float* t = wk.tri + static_cast<size_t>(q == c_a ? 2 * q + 1 : 2 * q) * 3 * D + c;
            pm[u] = __ldcg(t);
            ps[u] = __ldcg(t + D);
            pn[u] = __ldcg(t + 2 * D);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) merge3(M, S, N, pm[u], ps[u], pn[u]);
      }
      float va, vl;
      fwd_value(M, S, N, va, vl);
      aggr[static_cast<size_t>(r) * D + c] = va;
      if (lse != nullptr) lse[static_cast<size_t>(r) * D + c] = vl;
    }
    if (threadIdx.x == 0) wk.count[c_a] = 0;
  };
  const bool one = rg.nr == 1;
  if (rg.split_hi >= 0)
    arrive(one && rg.split_lo >= 0 ? rg.split_lo : cta, rg.split_hi, rg.r_lo + rg.nr - 1);
  if (rg.split_lo >= 0 && !(one && rg.split_hi >= 0)) arrive(rg.split_lo, cta, rg.r_lo);
}

// s += y with the rounding error carried in lost (Kahan).
__device__ __forceinline__ void kahan_add(float& s, float& lost, float y) {
  y -= lost;
  const float t = s + y;
  lost = (t - s) - y;
  s = t;
}

// The backward over chunks [e, e + kU) clipped to e_end, e += step, of
// one segment (its g, aggr and lse in gv, agv, lv): writes dpre (edge
// j0 + e, streaming) and adds to the lane's dw, db and dt. alpha is
// exp(t m - lse) and dt's term (g alpha m) (m - aggr), each operation
// rounded as the plain version rounds it (expf, no fused multiply-add), so
// that the terms are its terms; dt's terms have both signs and may sum to
// far less than their magnitudes, so each is added with compensation.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_edges(const Lane<T, VEC>& L, const Stage& st, int j0,
                                          int e, int e_end, int step, const float (&gv)[VEC],
                                          const float (&agv)[VEC], const float (&lv)[VEC],
                                          T* __restrict__ dpre, int ld, float (&dw)[VEC],
                                          float (&db)[VEC], float& dt, float& dt_lost) {
  for (; e < e_end; e += step) {
    float v[kU<VEC>][VEC];
    float av[kU<VEC>];
    const int n = gather_pieces<T, VEC>(L, st, e, e_end, v, av);
#pragma unroll
    for (int u = 0; u < kU<VEC>; ++u) {
      if (u < n) {
        float dp[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float pre = L.pre_of(v[u], av[u], k);
          const float m = fmaxf(pre, 0.f) + kEps;
          const float gal =
              __fmul_rn(gv[k], expf(__fsub_rn(__fmul_rn(L.t, m), lv[k])));   // g alpha
          const float dev = __fsub_rn(m, agv[k]);
          dp[k] = pre > 0.f ? gal * fmaf(L.t, dev, 1.f) : 0.f;
          dw[k] = fmaf(av[u], dp[k], dw[k]);
          db[k] += dp[k];
          kahan_add(dt, dt_lost, __fmul_rn(__fmul_rn(gal, m), dev));
        }
        store_piece<T, VEC>(dpre + static_cast<size_t>(j0 + e + u) * ld + L.c0, dp);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
gen_agg_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                   const float* __restrict__ a, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ b,
                   const T* __restrict__ tp, const float* __restrict__ g,
                   const float* __restrict__ aggr, const float* __restrict__ lse,
                   T* __restrict__ dpre, const Plan p, const Work wk) {
  __shared__ Stage st;
  __shared__ float s_w[kThreads * VEC];
  __shared__ float s_b[kThreads * VEC];
  __shared__ double s_t[kWarps];
  const Range rg = stage_cta(ptr, src, a, p, st);
  const int D = p.D;
  const int team = threadIdx.x >> p.g_log;
  const int gl = threadIdx.x & ((1 << p.g_log) - 1);
  const int teams = kThreads >> p.g_log;
  float* prow = wk.part + static_cast<size_t>(blockIdx.x) * (2 * D + 2);
  Lane<T, VEC> L;
  L.x = x;
  L.D = D;
  L.t = to_f<T>(*tp);
  L.keep = policy_evict_last();
  float dt = 0.f, dt_lost = 0.f;

  for (int s = 0; s < p.n_slabs; ++s) {
    const int piece = s * p.slab + gl;
    L.on = gl < p.slab && piece < p.pieces;
    L.c0 = piece * VEC;
    if (L.on) {
      load_piece<T, VEC>(w + L.c0, L.keep, L.w);
      load_piece<T, VEC>(b + L.c0, L.keep, L.b);
    }
    float dw[VEC], db[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      dw[k] = 0.f;
      db[k] = 0.f;
    }
    // segment k's edges from e on, every step-th chunk: each edge's dpre
    // needs only its segment's g, aggr and lse, so a segment split across
    // CTAs or teams needs no merge
    auto segment = [&](int k, int e, int step) {
      const int e1 = st.ptr[k + 1];
      if (!L.on || e >= e1) return;
      const size_t row = static_cast<size_t>(rg.r_lo + k) * D + L.c0;
      float gv[VEC], agv[VEC], lv[VEC];
      load_f32<VEC>(g + row, gv);
      load_f32<VEC>(aggr + row, agv);
      load_f32<VEC>(lse + row, lv);
      bwd_edges<T, VEC>(L, st, rg.j0, e, e1, step, gv, agv, lv, dpre, p.ld, dw, db, dt,
                        dt_lost);
    };
    for (int k = team; k < rg.nr; k += teams)
      if (st.ptr[k + 1] - st.ptr[k] <= kLongSeg) segment(k, st.ptr[k], kU<VEC>);
    for (int i = 0; i < st.n_long; ++i) {
      const int k = st.lng[i];
      segment(k, st.ptr[k] + team * kU<VEC>, teams * kU<VEC>);
    }
    // the slab's dw and db: the teams' sums added in team order
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s_w[threadIdx.x * VEC + k] = dw[k];
      s_b[threadIdx.x * VEC + k] = db[k];
    }
    __syncthreads();
    if (team == 0 && L.on) {
      for (int k = 0; k < VEC; ++k) {
        float sw = 0.f, sb = 0.f;
        for (int j = 0; j < teams; ++j) {
          const int i = ((j << p.g_log) + gl) * VEC + k;
          sw += s_w[i];
          sb += s_b[i];
        }
        prow[L.c0 + k] = sw;
        prow[D + L.c0 + k] = sb;
      }
    }
    __syncthreads();
  }
  // dt in fp64 from the lanes' compensated sums: a fixed shuffle tree a
  // warp, then the warps in order, into the row's last 8 bytes
  double dtd = static_cast<double>(dt) - static_cast<double>(dt_lost);
  for (int off = 16; off > 0; off >>= 1) dtd += __shfl_xor_sync(0xffffffffu, dtd, off);
  if ((threadIdx.x & 31) == 0) s_t[threadIdx.x >> 5] = dtd;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int i = 0; i < kWarps; ++i) sum += s_t[i];
    *reinterpret_cast<double*>(prow + 2 * D) = sum;
  }
}

// The backward's sums over the CTAs' rows of part (rows of 2D fp32, dw
// and db, then dt as one fp64) in a fixed order: out[c] for c < 2D with
// compensated (Kahan) sums, as a grid of a thousand CTAs gives a thousand
// rows, a CTA taking 32 columns (x) and kReduceGroups groups of rows (y),
// group y the rows y, y + kReduceGroups, ..., then the groups in order;
// the last CTA sums dt in fp64 the same way, into out[2D].
constexpr int kReduceGroups = 32;

__global__ void __launch_bounds__(32 * kReduceGroups)
gen_agg_reduce_kernel(const float* __restrict__ part, int rows, int D,
                      float* __restrict__ out) {
  __shared__ float s_sum[kReduceGroups][32], s_lost[kReduceGroups][32];
  __shared__ double s_dt[kReduceGroups];
  const int cols = 2 * D, stride = 2 * D + 2;
  if (blockIdx.x + 1 == gridDim.x) {
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int r = threadIdx.y; r < rows; r += kReduceGroups)
        s += *reinterpret_cast<const double*>(part + static_cast<size_t>(r) * stride + cols);
      s_dt[threadIdx.y] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      double s = 0.0;
      for (int y = 0; y < kReduceGroups; ++y) s += s_dt[y];
      out[cols] = static_cast<float>(s);
    }
    return;
  }
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, lost = 0.f;
  if (c < cols)
    for (int r = threadIdx.y; r < rows; r += kReduceGroups)
      kahan_add(s, lost, part[static_cast<size_t>(r) * stride + c]);
  s_sum[threadIdx.y][threadIdx.x] = s;
  s_lost[threadIdx.y][threadIdx.x] = lost;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    for (int y = 1; y < kReduceGroups; ++y) {
      kahan_add(s, lost, s_sum[y][threadIdx.x]);
      kahan_add(s, lost, -s_lost[y][threadIdx.x]);
    }
    out[c] = s;
  }
}

// What the launcher needs of the current device, read once per device.
constexpr int kMaxDevices = 64;
constexpr int kKinds = 8;   // (forward, backward) x (fp32, bf16) x (vector, scalar)
struct DeviceInfo {
  int sms = 0;
  int ctas[kKinds] = {};   // resident CTAs an SM of each kernel
};
DeviceInfo g_devices[kMaxDevices];

template <typename K>
cudaError_t device_info(K kernel, int kind, DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (d.sms == 0) {
    int sms = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    d.sms = sms;
  }
  if (d.ctas[kind] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    d.ctas[kind] = n > 0 ? n : 1;
  }
  *out = &d;
  return cudaSuccess;
}

// The plan and grid of a launch. Slab: kMaxSlab pieces, one a lane of a
// warp (narrower slabs that fit x in the L2 measured slower: each repeats
// the edge stream's walk). Grid: at most one CTA a kMinUnits units and one
// wave of resident CTAs, but whole waves enough that no CTA holds more than
// kStage units.
template <typename T, int VEC>
Plan make_plan(int num_dst, long long nnz, int D, int ld, const DeviceInfo& dev, int kind,
               long long* grid) {
  Plan p;
  p.num_dst = num_dst;
  p.D = D;
  p.pieces = D / VEC;
  p.slab = kMaxSlab < p.pieces ? kMaxSlab : p.pieces;
  p.n_slabs = (p.pieces + p.slab - 1) / p.slab;
  p.g_log = 0;
  while ((1 << p.g_log) < p.slab) ++p.g_log;
  p.ld = ld;
  p.units = num_dst + nnz;
  const long long wave = static_cast<long long>(dev.sms) * dev.ctas[kind];
  long long g = (p.units + kMinUnits - 1) / kMinUnits;
  if (g > wave) g = wave;
  const long long need = (p.units + kStage - 1) / kStage;
  if (need > g) g = (need + wave - 1) / wave * wave;
  *grid = g > 0 ? g : 1;
  return p;
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <typename T, int VEC>
int fwd(const int* ptr, const int* src, const float* a, const void* x, const void* w,
        const void* b, const void* t, float* aggr, float* lse, int num_dst, long long nnz,
        int D, int kind, void* count, long long count_bytes, void* ws,
        long long ws_bytes, cudaStream_t st) {
  DeviceInfo* dev = nullptr;
  cudaError_t err = device_info(gen_agg_fwd_kernel<T, VEC>, kind, &dev);
  if (err != cudaSuccess) return err;
  long long grid = 0;
  const Plan p = make_plan<T, VEC>(num_dst, nnz, D, D, *dev, kind, &grid);
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  // the arrival counts, and two (M, S, N) slots of D a CTA
  const long long need = grid * 2 * 3 * D * 4;
  if (count_bytes < grid * 4 || ws_bytes < need)
    return -static_cast<int>((need > grid * 4 ? need : grid * 4) / 1024 + 1);
  const Work wk = {static_cast<int*>(count), static_cast<float*>(ws), nullptr};
  gen_agg_fwd_kernel<T, VEC><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      ptr, src, a, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(t), aggr, lse, p, wk);
  return cudaGetLastError();
}

template <typename T, int VEC>
int bwd(const int* ptr, const int* src, const float* a, const void* x, const void* w,
        const void* b, const void* t, const float* g, const float* aggr, const float* lse,
        void* dpre, int ld, float* out, int num_dst, long long nnz, int D,
        int kind, void* ws, long long ws_bytes, cudaStream_t st) {
  DeviceInfo* dev = nullptr;
  cudaError_t err = device_info(gen_agg_bwd_kernel<T, VEC>, kind, &dev);
  if (err != cudaSuccess) return err;
  long long grid = 0;
  const Plan p = make_plan<T, VEC>(num_dst, nnz, D, ld, *dev, kind, &grid);
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const long long need = grid * (2 * D + 2) * 4;   // dw, db fp32 and dt fp64 a CTA
  if (ws_bytes < need) return -static_cast<int>((need + 1023) / 1024);
  const Work wk = {nullptr, nullptr, static_cast<float*>(ws)};
  gen_agg_bwd_kernel<T, VEC><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      ptr, src, a, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(t), g, aggr, lse, static_cast<T*>(dpre),
      p, wk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gen_agg_reduce_kernel<<<(2 * D + 31) / 32 + 1, dim3(32, kReduceGroups), 0, st>>>(
      wk.part, static_cast<int>(grid), D, out);
  return cudaGetLastError();
}

}  // namespace

// Forward. dtype: 0 = fp32, 1 = bf16 (x, w, b and t); ptr (num_dst+1) and
// src (nnz) int32, a (nnz) fp32, x (S, D), w and b (D), t one
// element; aggr and lse (num_dst, D) fp32, all contiguous; lse may be null,
// and then no lse is written. The kernel reads 16-byte pieces where D is a
// multiple of 4 (fp32) or 8 (bf16) and x, w, b, aggr and lse are 16-byte
// aligned, else one element at a time. count (count_bytes) holds the arrival counts: zeroed
// when first allocated and then left to the kernel, which hands it back
// zeroed; ws (ws_bytes) the parts' triples. Launches that share them must
// be ordered (one stream). Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for arguments it does not take, or -n
// without launching when count or ws holds fewer than n KiB.
extern "C" int lp_gen_agg_fwd(const void* ptr, const void* src, const void* a,
                              const void* x, const void* w, const void* b, const void* t,
                              void* aggr, void* lse, int num_dst, long long nnz,
                              int D, int dtype, void* count, long long count_bytes,
                              void* ws, long long ws_bytes, void* stream) {
  if (num_dst <= 0 || D <= 0 || nnz < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(src);
  const float* av = static_cast<const float*>(a);
  float* ag = static_cast<float*>(aggr);
  float* ls = static_cast<float*>(lse);
  const bool al = aligned16(x) && aligned16(w) && aligned16(b) && aligned16(aggr) &&
                  aligned16(lse);
  if (dtype == 0) {
    if (al && D % 4 == 0)
      return fwd<float, 4>(p, s, av, x, w, b, t, ag, ls, num_dst, nnz, D, 0,
                           count, count_bytes, ws, ws_bytes, st);
    return fwd<float, 1>(p, s, av, x, w, b, t, ag, ls, num_dst, nnz, D, 1, count,
                         count_bytes, ws, ws_bytes, st);
  }
  if (dtype == 1) {
    if (al && D % 8 == 0)
      return fwd<__nv_bfloat16, 8>(p, s, av, x, w, b, t, ag, ls, num_dst, nnz, D, 2,
                                   count, count_bytes, ws, ws_bytes, st);
    return fwd<__nv_bfloat16, 1>(p, s, av, x, w, b, t, ag, ls, num_dst, nnz, D, 3,
                                 count, count_bytes, ws, ws_bytes, st);
  }
  return cudaErrorInvalidValue;
}

// Backward. The forward's arguments, then g, aggr, lse (num_dst, D) fp32;
// dpre (nnz, ld) of x's type, ld >= D, its columns D..ld-1 zero-filled by
// the caller and left alone; out (2D+1) fp32 receives dw, db, dt; ws a
// workspace of one row a CTA, 2D fp32 and one fp64 (no zeroing needed). Returns as
// lp_gen_agg_fwd.
extern "C" int lp_gen_agg_bwd(const void* ptr, const void* src, const void* a,
                              const void* x, const void* w, const void* b, const void* t,
                              const void* g, const void* aggr, const void* lse, void* dpre,
                              int ld, void* out, int num_dst, long long nnz,
                              int D, int dtype, void* ws, long long ws_bytes,
                              void* stream) {
  if (num_dst <= 0 || D <= 0 || ld < D || nnz < 0 || lse == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(src);
  const float* av = static_cast<const float*>(a);
  const float* gv = static_cast<const float*>(g);
  const float* ag = static_cast<const float*>(aggr);
  const float* ls = static_cast<const float*>(lse);
  float* o = static_cast<float*>(out);
  const bool al = aligned16(x) && aligned16(w) && aligned16(b) && aligned16(g) &&
                  aligned16(aggr) && aligned16(lse) && aligned16(dpre);
  if (dtype == 0) {
    if (al && D % 4 == 0 && ld % 4 == 0)
      return bwd<float, 4>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, o, num_dst, nnz,
                           D, 4, ws, ws_bytes, st);
    return bwd<float, 1>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, o, num_dst, nnz,
                         D, 5, ws, ws_bytes, st);
  }
  if (dtype == 1) {
    if (al && D % 8 == 0 && ld % 8 == 0)
      return bwd<__nv_bfloat16, 8>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, o, num_dst, nnz,
                                   D, 6, ws, ws_bytes, st);
    return bwd<__nv_bfloat16, 1>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, o, num_dst, nnz,
                                 D, 7, ws, ws_bytes, st);
  }
  return cudaErrorInvalidValue;
}

// The registers, resident CTAs an SM and static shared memory (out[0..2])
// of the kernel that a launch with these arguments runs: backward 0 or 1,
// dtype as above, vector 1 where the launcher takes 16-byte pieces. For
// measurements; returns 0 or a CUDA error.
extern "C" int lp_gen_agg_attrs(int backward, int dtype, int vector, int* out) {
  auto get = [&](auto kernel) -> int {
    cudaFuncAttributes fa;
    int n = 0;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    out[0] = fa.numRegs;
    out[1] = n;
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    return err;
  };
  if (dtype == 0 && !backward)
    return vector ? get(gen_agg_fwd_kernel<float, 4>) : get(gen_agg_fwd_kernel<float, 1>);
  if (dtype == 0)
    return vector ? get(gen_agg_bwd_kernel<float, 4>) : get(gen_agg_bwd_kernel<float, 1>);
  if (dtype == 1 && !backward)
    return vector ? get(gen_agg_fwd_kernel<__nv_bfloat16, 8>)
                  : get(gen_agg_fwd_kernel<__nv_bfloat16, 1>);
  if (dtype == 1)
    return vector ? get(gen_agg_bwd_kernel<__nv_bfloat16, 8>)
                  : get(gen_agg_bwd_kernel<__nv_bfloat16, 1>);
  return cudaErrorInvalidValue;
}
