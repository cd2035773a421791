// CSR SpMM for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
//   out[d, :] = sum_{e in [ptr[d], ptr[d+1])} val[e] * x[idx[e], :]
//
// Replaces lp_gnn_tpu/ops/spmm.py:77 blocked_spmm (and its oracle :34
// segment_spmm), the bipartite aggregation of every GraphConv layer. The
// JAX package lowers it through XLA as a one-hot MXU contraction over
// chunked edge blocks; that layout exists for the TPU's matrix unit and
// has no counterpart here. On the H100 the same sum is a sorted segment
// reduction over the CSR: both directions of the two-tower conv use this
// one kernel, over the CSR of the row-sorted ordering for vars -> cons and
// the CSC of the col-sorted ordering for cons -> vars
// (lp_gnn_tpu_torch/data/graph.py).
//
// Types: x and out are fp32 or bf16, (S, D) and (num_dst, D) column slabs
// of row-major arrays whose rows lie ldx and ldo elements apart, 16-byte
// aligned, with D, ldx and ldo multiples of one 16-byte piece (4 fp32, 8
// bf16) and D at most 256 pieces (1024 fp32, 2048 bf16) a launch. The
// wrapper (ops/spmm.py spmm_csr) takes any width: a wider row is summed in
// slabs of 256 pieces, one launch each over the same arrays (ldx, ldo the
// full rows, the slab's first column 4096-byte aligned, nothing copied),
// and a width that is no whole number of pieces is summed over a copy of
// x padded to whole pieces into a padded output. A row stride of no whole
// number of 128-byte lines spreads each row's slab piece over one more
// line, so x's slab takes more of the L2 (D=1028 fp32 ran 1.29x D=1024's
// time on an H100: PERF.md). val is fp32; ptr and idx are int32. Each product and sum is taken in fp32 (fmaf) and
// rounded once to x's type, as blocked_spmm returns (ops/spmm.py:111-115).
// A row with no edges gives zeros. Every row is summed in an order fixed by
// the inputs' shapes: deterministic, no atomics.
//
// Bound. The least traffic is each input read once and the output written
// once: (num_dst+1)*4 (ptr) + E*8 (idx+val) + S_used*D*b (x rows that some
// edge references) + num_dst*D*b (out), over 3.35 TB/s. 2*E*D fp32 flops
// are far below the card's fp32 rate: the kernel is bound by bytes. The
// gathers themselves are E*D*b bytes, 5x the bound on the bench graph (each
// source row is read by ~8-15 edges), so the design's aim is that they come
// from L2 and the device memory sees little more than the bound's bytes.
//
// Design against that bound:
// 1. Feature slabs that stay in L2. D is cut into slabs of w 16-byte
//    pieces and the slab is the outermost loop of every CTA: all resident
//    CTAs gather from the same slab of x, which device memory supplies about
//    once, and the slab's E gathers hit L2. w is the widest power of two up
//    to 32 pieces, one a lane (D itself where narrower), whose S*w*16 bytes
//    fit in three quarters of the L2, but at least 8 pieces (one 128-byte
//    line). Each slab repeats every row's fixed cost (its bounds, its chain
//    of dependent loads, its store), so a slab narrower than that costs more
//    than the L2 misses it saves: on the H100 the bench graph's v2c
//    (S=131,072, D=1024 bf16) ran faster in slabs of 16 pieces (33.5 MB)
//    than of 8 (16.8 MB, half the L2) or of 32 (67 MB). Lanes that take 2 or
//    4 pieces each, for wider slabs, measured no faster and spilled.
// 2. Edge-balanced CTAs. The rows are cut by a merge path over
//    f(r) = r + ptr[r] (one unit per edge and per row, so long runs of empty
//    rows, which still write zeros, are balanced too): CTA c owns the rows
//    [r_c, r_{c+1}) with r_c the first row with f(r) >= c*(E+num_dst)/grid,
//    found by a 32-ary search of one warp. Every row is owned once. The
//    launcher sizes the grid so that a CTA's rows, but for its last row, hold
//    fewer than kStage - kLongRow edges, and the grid fills the card in
//    whole waves.
// 3. Staged index stream. Each CTA copies its (idx, val) range into shared
//    memory once with cp.async and reuses it for every slab, so the index
//    stream crosses device memory once and not once a slab.
// 4. L2 policy. Gathers of x carry an evict_last policy; the index stream
//    carries evict_first and the output is stored with the streaming hint
//    (st.global.cs), so neither pushes the slab out of L2.
// 5. Inside a slab. A group of G lanes (G = w rounded up to a power of two)
//    reads one edge's slab piece, 16 bytes a lane, neighbouring lanes on
//    neighbouring pieces, kUnroll edges in flight; a warp covers 32/G rows
//    at once, each lane walking its row's edges in order. Where a CTA has
//    fewer rows than lane groups (narrow widths: D=8 gives G=1), R groups
//    split one row's edges (group g takes edges g, g+R, ...) and combine by
//    a fixed xor-shuffle tree, so every lane has work.
// 6. Long rows. A row of more than kLongRow edges is summed by the whole CTA:
//    every lane group of the CTA takes a strided share of its edges (read
//    from device memory, evict_first), each warp folds its groups by
//    shuffles, and one warp adds the warps' partials from shared memory in
//    warp order. A long row that runs past its CTA's share of the merge path
//    (a dense linking row) is split: every CTA whose share it spans sums its
//    part into the caller's workspace, and the last to arrive (an atomic
//    count) adds the parts in CTA order, so the sum is still deterministic
//    and the launch still one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 4096;        // edges a CTA stages in shared memory (32 KB)
constexpr int kLongRow = 256;       // a longer row is summed by the whole CTA
constexpr int kUnroll = 4;          // gathers in flight a lane
constexpr int kMaxSlab = 32;        // pieces of a slab: one a lane
constexpr int kMaxPieces = 256;     // pieces a launch sums (1024 fp32, 2048 bf16)
constexpr int kMinUnits = 64;       // least merge-path units worth a CTA
constexpr int kL2Share = 3;         // quarters of the L2 a slab of x may fill

// 16-byte pieces: fp32 (4 elements) or bf16 (8 elements).
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void fma(float* acc, const uint4& v, float w) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
  static __device__ __forceinline__ float one(float a) { return a; }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void fma(float* acc, const uint4& v, float w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float a) { return __float2bfloat16_rn(a); }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return v;
  }
};

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

// A 16-byte read-only gather of x under an L2 policy.
__device__ __forceinline__ uint4 ld_x(const void* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_idx(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_val(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, uint64_t pol) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "l"(pol) : "memory");
}

// The first row r in [0, n] with r + ptr[r] >= t (n when there is none),
// by one warp: 32 probes a step cut the interval 33-fold. Also returns
// ptr[r], read by the probe that found it.
__device__ int2 merge_path_row(const int* __restrict__ ptr, int n, long long t, int lane) {
  int lo = 0, hi = n;
  int ptr_hi = __ldg(ptr + n);
  while (lo < hi) {
    const int q = lo + static_cast<int>(static_cast<long long>(hi - lo) * (lane + 1) / 33);
    const int pq = __ldg(ptr + q);
    const bool ge = static_cast<long long>(q) + pq >= t;
    const unsigned below = ~__ballot_sync(0xffffffffu, ge);  // probes left of the answer
    const int k = __popc(below);                              // they are lanes 0..k-1
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
  int pieces;    // 16-byte pieces of a row's columns summed here
  long long ldx; // elements from one row of x to the next
  long long ldo; // elements from one row of out to the next
  int slab;      // pieces of a slab (<= kMaxSlab)
  int n_slabs;
  int g_log;     // log2 G: lanes on one edge's slab piece (G >= slab)
  int r_log;     // log2 R: lane groups splitting one row's edges
  long long units;  // num_dst + E: the merge path's length
};

// The caller's workspace for rows split across CTAs: part[2c+1] holds CTA
// c's share of the row it owns, part[2c] its share of the row it helps
// with (D fp32 each); count[c] counts the arrivals at the row CTA c owns
// and is 0 again when the kernel ends.
struct Split {
  float* part;
  int* count;
};

// CTA c's merge-path target: its units start there (CTA 0 and the end of
// the grid lie beyond every r + ptr[r]).
__device__ __forceinline__ long long target(int c, long long units, int grid) {
  constexpr long long kFar = 1LL << 62;
  return c <= 0 ? -kFar : c >= grid ? kFar : c * units / grid;
}

// The first CTA whose target is at or past unit f >= 0.
__device__ __forceinline__ int first_cta_at(long long f, long long units, int grid) {
  const long long c = (f * grid + units - 1) / units;
  return static_cast<int>(c < 1 ? 1 : c > grid ? grid : c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
spmm_csr_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ val, const T* __restrict__ x,
                T* __restrict__ out, const Plan p, const Split sp) {
  constexpr int VEC = Vec<T>::kN;
  __shared__ int s_idx[kStage];
  __shared__ float s_val[kStage];
  __shared__ float s_part[kWarps][kMaxSlab * VEC];
  __shared__ int2 s_rows[2];
  __shared__ int s_last;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grid = gridDim.x;
  const int cta = blockIdx.x;
  const long long t0 = target(cta, p.units, grid);
  const long long t1 = target(cta + 1, p.units, grid);

  // rows [rb, re) of this CTA with ptr[rb], ptr[re]: warp 0 finds the
  // first row, warp 1 the next CTA's
  if (warp < 2) {
    const int2 r = merge_path_row(ptr, p.num_dst, warp ? t1 : t0, lane);
    if (lane == 0) s_rows[warp] = r;
  }
  __syncthreads();
  const int rb = s_rows[0].x, re = s_rows[1].x;
  const int eb = s_rows[0].y, ee = s_rows[1].y;

  // A long row whose units run past its owner's last target is split: each
  // CTA whose units it spans sums its share, and the last to arrive adds the
  // shares in CTA order. This CTA helps with row rb-1 when its first unit
  // lies inside it, and owns a split row when its last row runs past t1.
  int help_row = -1, h0 = 0, h1 = 0, help_c0 = 0, help_end = 0;
  if (cta > 0 && rb > 0 && rb + static_cast<long long>(eb) > t0) {
    const int pr = __ldg(ptr + rb - 1);
    if (eb - pr > kLongRow) {
      const long long f = rb - 1 + static_cast<long long>(pr);  // the row's first unit
      const long long fe = rb + static_cast<long long>(eb);     // past its last
      help_row = rb - 1;
      h0 = static_cast<int>(max(static_cast<long long>(pr), min(pr + t0 - f - 1, static_cast<long long>(eb))));
      h1 = static_cast<int>(max(static_cast<long long>(h0), min(pr + min(t1, fe) - f - 1, static_cast<long long>(eb))));
      help_c0 = first_cta_at(f + 1, p.units, grid) - 1;
      help_end = first_cta_at(fe, p.units, grid);
    }
  }
  int own_end = 0, own_split_end = 0;  // the owned split row's share ends at own_end
  if (re > rb) {
    const int pl = __ldg(ptr + re - 1);
    const long long fe = re + static_cast<long long>(ee);
    if (ee - pl > kLongRow && fe > t1) {
      const long long f = re - 1 + static_cast<long long>(pl);
      own_end = static_cast<int>(max(static_cast<long long>(pl), min(pl + t1 - f - 1, static_cast<long long>(ee))));
      own_split_end = first_cta_at(fe, p.units, grid);
    }
  }
  if (rb >= re && help_row < 0) return;
  const int staged = max(0, min(ee - eb, kStage));

  // the index stream of the CTA's rows, staged once for all slabs
  const uint64_t first = policy_evict_first();
  const uint64_t last = policy_evict_last();
  for (int i = threadIdx.x; i < staged; i += kThreads) {
    cp_async4(s_idx + i, idx + eb + i, first);
    cp_async4(s_val + i, val + eb + i, first);
  }

  // a row is long when it has more than kLongRow edges or ends past the
  // staged range (only the CTA's last row can); the same test in both phases
  auto is_long = [&](int r, int& e0, int& e1) {
    e0 = __ldg(ptr + r);
    e1 = __ldg(ptr + r + 1);
    return e1 - e0 > kLongRow || e1 - eb > staged;
  };
  int mine = 0;
  for (int r = rb + threadIdx.x; r < re; r += kThreads) {
    int e0, e1;
    mine |= is_long(r, e0, e1);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  const bool any_long = __syncthreads_or(mine);  // also publishes the staged stream

  const int D = p.pieces * VEC;
  const int G = 1 << p.g_log;
  const int R = 1 << p.r_log;
  const int team_log = p.g_log + p.r_log;        // lanes on one row: G*R
  const int teams = 32 >> team_log;              // rows a warp at once
  const int team = lane >> team_log;
  const int grp = (lane >> p.g_log) & (R - 1);
  const int gl = lane & (G - 1);
  const int n_groups = kWarps << (5 - p.g_log);  // lane groups of the CTA
  const int gi = threadIdx.x >> p.g_log;

  // edges [e0, e1) of one row, this slab, by the whole CTA: every lane group
  // takes a strided share, each warp folds its groups by shuffles, and warp
  // 0 adds the warps' sums in order into o (the output row) or f (a share)
  auto cta_sum = [&](int e0, int e1, bool on, size_t col, T* o, float* f) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int e = e0 + gi; e < e1; e += n_groups * kUnroll) {
      int src[kUnroll];
      float w[kUnroll];
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int eu = e + u * n_groups;
        src[u] = eu < e1 ? ld_idx(idx + eu, first) : -1;
        w[u] = eu < e1 ? ld_val(val + eu, first) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (on && src[u] >= 0) v[u] = ld_x(x + static_cast<size_t>(src[u]) * p.ldx + col, last);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (on && src[u] >= 0) Vec<T>::fma(acc, v[u], w[u]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      for (int off = G; off < 32; off <<= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    if (lane < G) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) s_part[warp][lane * VEC + k] = acc[k];
    }
    __syncthreads();
    if (warp == 0 && lane < G && on) {
      float sum[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum[k] += s_part[w][lane * VEC + k];
      if (o != nullptr) {
        __stcs(reinterpret_cast<uint4*>(o + col), Vec<T>::pack(sum));
      } else {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
          __stcg(reinterpret_cast<float4*>(f + col + k),
                 make_float4(sum[k], sum[k + 1], sum[k + 2], sum[k + 3]));
      }
    }
    __syncthreads();
  };

  for (int s = 0; s < p.n_slabs; ++s) {
    const int piece = s * p.slab + gl;
    const bool on = gl < p.slab && piece < p.pieces;
    const size_t col = static_cast<size_t>(piece) * VEC;

    // short rows: one team of R groups a row
    for (int base = rb + warp * teams; base < re; base += kWarps * teams) {
      const int r = base + team;
      int e0 = 0, e1 = 0;
      bool write = false;
      if (r < re) {
        write = !is_long(r, e0, e1);
        if (!write) e1 = e0;
      }
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      for (int e = e0 + grp; e < e1; e += R * kUnroll) {
        int src[kUnroll];
        float w[kUnroll];
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int eu = e + u * R;
          src[u] = eu < e1 ? s_idx[eu - eb] : -1;
          w[u] = eu < e1 ? s_val[eu - eb] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (on && src[u] >= 0) v[u] = ld_x(x + static_cast<size_t>(src[u]) * p.ldx + col, last);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (on && src[u] >= 0) Vec<T>::fma(acc, v[u], w[u]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        for (int off = G; off < (G << p.r_log); off <<= 1)
          acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      if (write && grp == 0 && on)
        __stcs(reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * p.ldo + col),
               Vec<T>::pack(acc));
    }

    // long rows, the whole CTA on each; every warp scans the same 32 rows
    // at a time, so the ballot, and with it the control flow, is uniform
    if (any_long) {
      for (int base = rb; base < re; base += 32) {
        int e0 = 0, e1 = 0;
        const bool lg = base + lane < re && is_long(base + lane, e0, e1);
        unsigned m = __ballot_sync(0xffffffffu, lg);
        while (m) {
          const int r = base + __ffs(m) - 1;
          m &= m - 1;
          const int r0 = __ldg(ptr + r);
          if (own_split_end && r == re - 1)
            cta_sum(r0, own_end, on, col, nullptr, sp.part + static_cast<size_t>(2 * cta + 1) * D);
          else
            cta_sum(r0, __ldg(ptr + r + 1), on, col, out + static_cast<size_t>(r) * p.ldo, nullptr);
        }
      }
    }
    if (help_row >= 0)
      cta_sum(h0, h1, on, col, nullptr, sp.part + static_cast<size_t>(2 * cta) * D);
  }

  // a split row's shares: the last CTA to arrive adds them in CTA order
  auto arrive = [&](int c0, int c_end, int row) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(sp.count + c0, 1) == c_end - c0 - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int k = threadIdx.x; k < D; k += kThreads) {
      float sum = __ldcg(sp.part + static_cast<size_t>(2 * c0 + 1) * D + k);
      for (int c = c0 + 1; c < c_end; ++c) sum += __ldcg(sp.part + static_cast<size_t>(2 * c) * D + k);
      out[static_cast<size_t>(row) * p.ldo + k] = Vec<T>::one(sum);
    }
    if (threadIdx.x == 0) sp.count[c0] = 0;
  };
  if (own_split_end) arrive(cta, own_split_end, re - 1);
  if (help_row >= 0) arrive(help_c0, help_end, help_row);
}

// What the launcher needs of the current device, read once per device.
struct DeviceInfo {
  int sms = 0;
  long long l2_bytes = 0;
  int ctas[2] = {0, 0};  // resident CTAs an SM: fp32, bf16 kernel
};
constexpr int kMaxDevices = 64;
DeviceInfo g_devices[kMaxDevices];

template <typename T>
cudaError_t device_info(int kind, DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (d.sms == 0) {
    int sms = 0, l2 = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)))
      return err;
    d.l2_bytes = l2;
    d.sms = sms;
  }
  if (d.ctas[kind] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, spmm_csr_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return err;
    d.ctas[kind] = n > 0 ? n : 1;
  }
  *out = &d;
  return cudaSuccess;
}

template <typename T>
int launch(const int* ptr, const int* idx, const float* val, const void* x, void* out,
           int num_dst, int num_src, long long nnz, int D, long long ldx, long long ldo,
           int kind, void* count, long long count_bytes, void* ws, long long ws_bytes,
           cudaStream_t stream) {
  constexpr int VEC = Vec<T>::kN;
  const int pieces = D / VEC;
  if (D % VEC != 0 || pieces > kMaxPieces || ldx < D || ldo < D || ldx % VEC != 0 ||
      ldo % VEC != 0 || num_src < 0 || nnz < 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(ws)) % 16 != 0)
    return cudaErrorInvalidValue;
  DeviceInfo* dev = nullptr;
  const cudaError_t err = device_info<T>(kind, &dev);
  if (err != cudaSuccess) return err;

  // slab: the widest power of two up to kMaxSlab pieces whose S*slab*16
  // bytes fit in kL2Share of the L2, but at least 8 pieces (one 128-byte
  // line): a narrower slab repeats each row's overhead over more slabs
  const long long budget = dev->l2_bytes * kL2Share / 4;
  int slab = kMaxSlab;
  while (slab > 8 && static_cast<long long>(num_src) * 16 * slab > budget) slab >>= 1;
  slab = slab < pieces ? slab : pieces;
  int g_log = 0;
  while ((1 << g_log) < slab) ++g_log;

  // grid: whole waves of resident CTAs, each with fewer than
  // kStage - kLongRow units but for its last row
  const long long units = num_dst + nnz;
  const long long wave = static_cast<long long>(dev->sms) * dev->ctas[kind];
  long long grid = (units + kMinUnits - 1) / kMinUnits;
  if (grid > wave) grid = wave;
  const long long need = (units + (kStage - kLongRow) - 1) / (kStage - kLongRow);
  if (need > grid) grid = (need + wave - 1) / wave * wave;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  // the arrival counts, and two fp32 shares of D a CTA
  const long long ws_need = grid * 2 * D * 4;
  if (count_bytes < grid * 4 || ws_bytes < ws_need)
    return -static_cast<int>((ws_need > grid * 4 ? ws_need : grid * 4) / 1024 + 1);

  // R: lane groups split a row's edges only where a CTA has fewer rows than
  // lane groups (narrow widths, long rows): the split costs a shuffle tree
  const long long rows_per_cta = (num_dst + grid - 1) / grid;
  int r_log = 0;
  while (g_log + r_log < 5 && (rows_per_cta << (r_log + 1)) <= (kThreads >> g_log)) ++r_log;

  const Plan plan = {num_dst, pieces, ldx, ldo, slab, (pieces + slab - 1) / slab,
                     g_log, r_log, units};
  const Split split = {static_cast<float*>(ws), static_cast<int*>(count)};
  spmm_csr_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      ptr, idx, val, static_cast<const T*>(x), static_cast<T*>(out), plan, split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (D a multiple of 4, at most 1024), 1 = bf16 (D a multiple
// of 8, at most 2048): the D columns of x (num_src rows, ldx elements apart)
// summed into the D columns of out (num_dst rows, ldo apart), ldx and ldo
// multiples of 4 (fp32) or 8 (bf16) and at least D; x, out and ws 16-byte
// aligned; ptr a CSR over nnz = len(idx) = ptr[num_dst] edges (ptr[0] = 0,
// non-decreasing). count (count_bytes) holds the arrival counts of split
// rows: zeroed when first allocated and then left to the kernel, which
// hands it back zeroed; ws (ws_bytes) the split rows' shares. Launches that
// share them must be ordered (one stream). Returns cudaGetLastError() after
// the launch (0 = launched), cudaErrorInvalidValue for arguments the kernel
// does not take, or -n without launching when count or ws holds fewer than
// n KiB; the caller raises on anything but 0 and -n.
extern "C" int lp_spmm_csr(const void* ptr, const void* idx, const void* val,
                           const void* x, void* out, int num_dst, int num_src,
                           long long nnz, int D, long long ldx, long long ldo, int dtype,
                           void* count, long long count_bytes, void* ws, long long ws_bytes,
                           void* stream) {
  if (num_dst <= 0 || D <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(val);
  if (dtype == 0)
    return launch<float>(p, i, v, x, out, num_dst, num_src, nnz, D, ldx, ldo, 0, count,
                         count_bytes, ws, ws_bytes, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, i, v, x, out, num_dst, num_src, nnz, D, ldx, ldo, 1, count,
                                 count_bytes, ws, ws_bytes, st);
  return cudaErrorInvalidValue;
}
