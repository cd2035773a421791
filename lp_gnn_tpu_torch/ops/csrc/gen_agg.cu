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
// (E, D) edge tensors (gather, encoder, max, exp, two segment sums); here
// the forward is one pass with no (E, D) tensor in device memory.
//
// gen_agg_fwd_kernel: an online softmax per segment and channel (running
// max M, sum of exp S, sum of exp * m N, fp32 in registers), writing aggr =
// N / S and lse = M + log S (fp32, num_dst x D) for the backward.
//
// gen_agg_bwd_kernel: per segment it recomputes m and alpha = exp(t m -
// lse) and, with g = dL/daggr, writes
//   dpre = g alpha (1 + t (m - aggr)) [pre > 0]
// per edge, in x's type, into rows of stride ld >= D (the caller zero-fills
// the padding, so that the CSR SpMM can read the rows: the gather's
// backward is csrc/spmm.cu over the transpose ordering, not a kernel
// here). Each CTA also writes its partial sums of a_T dpre (dw), dpre (db)
// and g alpha m (m - aggr) (dt) into one row of a workspace, and
// gen_agg_reduce_kernel adds the rows in CTA order. No float atomics: two
// calls give the same bits.
//
// Bound. Bytes: ptr, src and a read once, the rows of x that some edge
// references, aggr and lse written (forward); g, aggr and lse read and dpre
// written (backward). About 15-25 fp32 operations and one exp a (edge,
// channel) are far below the card's fp32 rate: both kernels are bound by
// bytes, and the gathers of x rows (E x D x sizeof(T), 2-15x the bound's x
// bytes on the bench graph) come from L2 where x fits it.
//
// Design against that bound:
// 1. A team of G lanes (G a power of two, <= 32) takes one segment; lane l
//    holds one piece of VEC channels (16 bytes of x where D allows it, else
//    one channel), so a team reads a row of x as neighbouring 16-byte
//    pieces. D wider than 32 pieces is taken in slabs of 32 pieces.
// 2. Each CTA walks blocks of `teams` consecutive segments (grid-stride
//    over the blocks, a grid of whole waves): team j takes segment j of the
//    block, kUnroll edges in flight.
// 3. Long segments (more than kLongSeg edges) are taken by the whole CTA:
//    team j takes edges j, j + teams, ...; in the forward the teams' (M, S,
//    N) triples are merged through shared memory in team order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLongSeg = 64;     // a longer segment is taken by the whole CTA
constexpr int kUnroll = 4;       // edges in flight a team
constexpr int kMaxVec = 8;       // channels a lane
constexpr int kMaxPieces = 32;   // pieces of a slab: one a lane
constexpr float kEps = 1e-7f;

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

// VEC elements of T from p: one 16-byte load where VEC * sizeof(T) is 16
// (p then 16-byte aligned), else element by element.
template <typename T, int VEC>
__device__ __forceinline__ void load_piece(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(u.x);
      v[1] = __uint_as_float(u.y);
      v[2] = __uint_as_float(u.z);
      v[3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_f<T>(p[k]);
  }
}

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
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_f<T>(v[k]);
  }
}

// VEC fp32 values: float4 pieces where VEC is a multiple of 4 (p then
// 16-byte aligned), else one by one.
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
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

struct Plan {
  int num_dst;
  int D;
  int pieces;    // pieces of a row: D / VEC
  int g_log;     // log2 G: lanes of a team
  int n_slabs;   // slabs of up to G pieces
  int teams;     // teams of a CTA = segments of a block
  int n_blocks;  // blocks of `teams` consecutive segments
  int ld;        // row stride of dpre (backward)
};

// One lane's view of a direction: its piece of VEC channels, with the edge
// encoder's weights there and the temperature, in fp32.
template <typename T, int VEC>
struct Lane {
  const int* __restrict__ src;
  const float* __restrict__ a;
  const T* __restrict__ x;
  int D;
  int c0;    // first channel of the lane's piece
  bool on;   // the piece lies inside the row
  float t;
  float w[VEC], b[VEC];

  // The pre-activation of channel c0 + k of an edge with a_T = ae whose
  // source row's piece is xv: x + (a w + b), each operation rounded (no
  // fused multiply-add), so that the plain versions' fp32 arithmetic gives
  // the same bits and the relu mask of the backward is theirs.
  __device__ __forceinline__ float pre_of(const float (&xv)[VEC], float ae, int k) const {
    return __fadd_rn(xv[k], __fadd_rn(__fmul_rn(ae, w[k]), b[k]));
  }
};

// Online softmax over edges e_begin, e_begin + stride, ... < e_end into the
// running (M, S, N) of each channel, in edge order.
template <typename T, int VEC>
__device__ __forceinline__ void fwd_edges(const Lane<T, VEC>& L, int e_begin, int e_end,
                                          int stride, float (&M)[VEC], float (&S)[VEC],
                                          float (&N)[VEC]) {
  for (int e = e_begin; e < e_end; e += stride * kUnroll) {
    float xv[kUnroll][VEC];
    float av[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int eu = e + u * stride;
      ok[u] = L.on && eu < e_end;
      if (ok[u]) {
        const int s = __ldg(L.src + eu);
        av[u] = to_f<T>(from_f<T>(__ldg(L.a + eu)));
        load_piece<T, VEC>(L.x + static_cast<size_t>(s) * L.D + L.c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float m = fmaxf(L.pre_of(xv[u], av[u], k), 0.f) + kEps;
        const float z = L.t * m;
        // one exp and no branch: f = exp(-|z - M|) rescales the old sums
        // when z is the new max (f = 0 while M is -inf), else weighs z
        const float d = z - M[k];
        const float f = expf(-fabsf(d));
        const bool up = d > 0.f;
        const float keep = up ? f : 1.f;
        const float add = up ? 1.f : f;
        S[k] = fmaf(S[k], keep, add);
        N[k] = fmaf(N[k], keep, add * m);
        M[k] = up ? z : M[k];
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void fwd_store(float* __restrict__ aggr, float* __restrict__ lse,
                                          int r, int D, int c0, const float (&M)[VEC],
                                          const float (&S)[VEC], const float (&N)[VEC]) {
  float va[VEC], vl[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const bool any = S[k] > 0.f;   // an empty segment gives 0
    va[k] = any ? N[k] / S[k] : 0.f;
    vl[k] = any ? M[k] + logf(S[k]) : 0.f;
  }
  store_f32<VEC>(aggr + static_cast<size_t>(r) * D + c0, va);
  store_f32<VEC>(lse + static_cast<size_t>(r) * D + c0, vl);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gen_agg_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                   const float* __restrict__ a, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ b,
                   const T* __restrict__ tp, float* __restrict__ aggr,
                   float* __restrict__ lse, const Plan p) {
  __shared__ float s_m[kThreads * kMaxVec];
  __shared__ float s_s[kThreads * kMaxVec];
  __shared__ float s_n[kThreads * kMaxVec];
  const int G = 1 << p.g_log;
  const int team = threadIdx.x >> p.g_log;
  const int gl = threadIdx.x & (G - 1);
  Lane<T, VEC> L{src, a, x, p.D, 0, false, to_f<T>(*tp), {}, {}};

  for (int s = 0; s < p.n_slabs; ++s) {
    const int piece = s * G + gl;
    L.on = piece < p.pieces;
    L.c0 = piece * VEC;
    if (L.on) {
      load_piece<T, VEC>(w + L.c0, L.w);
      load_piece<T, VEC>(b + L.c0, L.b);
    }
    for (int blk = blockIdx.x; blk < p.n_blocks; blk += gridDim.x) {
      const int r0 = blk * p.teams;
      const int r1 = min(r0 + p.teams, p.num_dst);
      // short segments: one a team
      const int r = r0 + team;
      if (r < r1) {
        const int e0 = __ldg(ptr + r), e1 = __ldg(ptr + r + 1);
        if (e1 - e0 <= kLongSeg) {
          float M[VEC], S[VEC], N[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            M[k] = -INFINITY;
            S[k] = 0.f;
            N[k] = 0.f;
          }
          fwd_edges<T, VEC>(L, e0, e1, 1, M, S, N);
          if (L.on) fwd_store<T, VEC>(aggr, lse, r, p.D, L.c0, M, S, N);
        }
      }
      // long segments: the whole CTA on each (the test reads the same ptr
      // entries in every thread, so the branch and its barriers are uniform)
      for (int rl = r0; rl < r1; ++rl) {
        const int e0 = __ldg(ptr + rl), e1 = __ldg(ptr + rl + 1);
        if (e1 - e0 <= kLongSeg) continue;
        float M[VEC], S[VEC], N[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          M[k] = -INFINITY;
          S[k] = 0.f;
          N[k] = 0.f;
        }
        fwd_edges<T, VEC>(L, e0 + team, e1, p.teams, M, S, N);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s_m[threadIdx.x * VEC + k] = M[k];
          s_s[threadIdx.x * VEC + k] = S[k];
          s_n[threadIdx.x * VEC + k] = N[k];
        }
        __syncthreads();
        if (team == 0 && L.on) {
          // merge the teams' triples in team order
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            M[k] = -INFINITY;
            S[k] = 0.f;
            N[k] = 0.f;
          }
          for (int j = 0; j < p.teams; ++j) {
            const int i = ((j << p.g_log) + gl) * VEC;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float sj = s_s[i + k];
              if (sj == 0.f) continue;
              const float mj = s_m[i + k], nj = s_n[i + k];
              if (mj > M[k]) {
                const float f = expf(M[k] - mj);
                S[k] = fmaf(S[k], f, sj);
                N[k] = fmaf(N[k], f, nj);
                M[k] = mj;
              } else {
                const float f = expf(mj - M[k]);
                S[k] = fmaf(sj, f, S[k]);
                N[k] = fmaf(nj, f, N[k]);
              }
            }
          }
          fwd_store<T, VEC>(aggr, lse, rl, p.D, L.c0, M, S, N);
        }
        __syncthreads();
      }
    }
  }
}

// The backward over edges e_begin, e_begin + stride, ... < e_end of segment
// r: writes dpre and adds to the lane's dw, db and dt partials.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_edges(const Lane<T, VEC>& L, int r, int e_begin, int e_end,
                                          int stride, const float* __restrict__ g,
                                          const float* __restrict__ aggr,
                                          const float* __restrict__ lse, T* __restrict__ dpre,
                                          int ld, float (&dw)[VEC], float (&db)[VEC],
                                          float& dt) {
  if (!L.on || e_begin >= e_end) return;
  float gv[VEC], agv[VEC], lv[VEC];
  const size_t row = static_cast<size_t>(r) * L.D + L.c0;
  load_f32<VEC>(g + row, gv);
  load_f32<VEC>(aggr + row, agv);
  load_f32<VEC>(lse + row, lv);
  for (int e = e_begin; e < e_end; e += stride * kUnroll) {
    float xv[kUnroll][VEC];
    float av[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int eu = e + u * stride;
      ok[u] = eu < e_end;
      if (ok[u]) {
        const int s = __ldg(L.src + eu);
        av[u] = to_f<T>(from_f<T>(__ldg(L.a + eu)));
        load_piece<T, VEC>(L.x + static_cast<size_t>(s) * L.D + L.c0, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float dp[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float pre = L.pre_of(xv[u], av[u], k);
        const float m = fmaxf(pre, 0.f) + kEps;
        const float al = expf(L.t * m - lv[k]);
        const float gal = gv[k] * al;
        const float dm = gal * fmaf(L.t, m - agv[k], 1.f);
        dp[k] = pre > 0.f ? dm : 0.f;
        dw[k] = fmaf(av[u], dp[k], dw[k]);
        db[k] += dp[k];
        dt = fmaf(gal * m, m - agv[k], dt);
      }
      store_piece<T, VEC>(dpre + static_cast<size_t>(e + u * stride) * ld + L.c0, dp);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gen_agg_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                   const float* __restrict__ a, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ b,
                   const T* __restrict__ tp, const float* __restrict__ g,
                   const float* __restrict__ aggr, const float* __restrict__ lse,
                   T* __restrict__ dpre, float* __restrict__ part, const Plan p) {
  __shared__ float s_w[kThreads * kMaxVec];
  __shared__ float s_b[kThreads * kMaxVec];
  __shared__ float s_t[kWarps];
  const int G = 1 << p.g_log;
  const int team = threadIdx.x >> p.g_log;
  const int gl = threadIdx.x & (G - 1);
  const int cols = 2 * p.D + 1;   // a workspace row: dw, db, dt
  float* prow = part + static_cast<size_t>(blockIdx.x) * cols;
  Lane<T, VEC> L{src, a, x, p.D, 0, false, to_f<T>(*tp), {}, {}};
  float dt = 0.f;

  for (int s = 0; s < p.n_slabs; ++s) {
    const int piece = s * G + gl;
    L.on = piece < p.pieces;
    L.c0 = piece * VEC;
    if (L.on) {
      load_piece<T, VEC>(w + L.c0, L.w);
      load_piece<T, VEC>(b + L.c0, L.b);
    }
    float dw[VEC], db[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      dw[k] = 0.f;
      db[k] = 0.f;
    }
    for (int blk = blockIdx.x; blk < p.n_blocks; blk += gridDim.x) {
      const int r0 = blk * p.teams;
      const int r1 = min(r0 + p.teams, p.num_dst);
      const int r = r0 + team;
      if (r < r1) {
        const int e0 = __ldg(ptr + r), e1 = __ldg(ptr + r + 1);
        if (e1 - e0 <= kLongSeg)
          bwd_edges<T, VEC>(L, r, e0, e1, 1, g, aggr, lse, dpre, p.ld, dw, db, dt);
      }
      for (int rl = r0; rl < r1; ++rl) {
        const int e0 = __ldg(ptr + rl), e1 = __ldg(ptr + rl + 1);
        if (e1 - e0 > kLongSeg)
          bwd_edges<T, VEC>(L, rl, e0 + team, e1, p.teams, g, aggr, lse, dpre, p.ld, dw, db,
                            dt);
      }
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
        for (int j = 0; j < p.teams; ++j) {
          const int i = ((j << p.g_log) + gl) * VEC + k;
          sw += s_w[i];
          sb += s_b[i];
        }
        prow[L.c0 + k] = sw;
        prow[p.D + L.c0 + k] = sb;
      }
    }
    __syncthreads();
  }
  // dt: a fixed shuffle tree a warp, then the warps in order
  for (int off = 16; off > 0; off >>= 1) dt += __shfl_xor_sync(0xffffffffu, dt, off);
  if ((threadIdx.x & 31) == 0) s_t[threadIdx.x >> 5] = dt;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < kWarps; ++i) sum += s_t[i];
    prow[2 * p.D] = sum;
  }
}

// out[c] = sum over rows r < rows of part[r, c], rows in order.
__global__ void gen_agg_reduce_kernel(const float* __restrict__ part, int rows, int cols,
                                      float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[static_cast<size_t>(r) * cols + c];
  out[c] = s;
}

constexpr int kMaxDevices = 64;
constexpr int kKinds = 8;   // (forward, backward) x (fp32, bf16) x (vector, scalar)
int g_sms[kMaxDevices];
int g_ctas[kMaxDevices][kKinds];

// The grid: whole waves of resident CTAs, at most one a block and at most
// max_grid (the backward's workspace rows).
template <typename K>
cudaError_t pick_grid(K kernel, int kind, int n_blocks, int max_grid, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    int sms = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    g_sms[dev] = sms;
  }
  if (g_ctas[dev][kind] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    g_ctas[dev][kind] = n > 0 ? n : 1;
  }
  long long g = static_cast<long long>(g_sms[dev]) * g_ctas[dev][kind];
  if (g > n_blocks) g = n_blocks;
  if (g > max_grid) g = max_grid;
  *grid = g > 0 ? static_cast<int>(g) : 1;
  return cudaSuccess;
}

template <typename T, int VEC>
Plan make_plan(int num_dst, int D, int ld) {
  Plan p;
  p.num_dst = num_dst;
  p.D = D;
  p.pieces = D / VEC;
  const int lanes = p.pieces < kMaxPieces ? p.pieces : kMaxPieces;
  p.g_log = 0;
  while ((1 << p.g_log) < lanes) ++p.g_log;
  p.n_slabs = (p.pieces + (1 << p.g_log) - 1) >> p.g_log;
  p.teams = kThreads >> p.g_log;
  p.n_blocks = (num_dst + p.teams - 1) / p.teams;
  p.ld = ld;
  return p;
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <typename T, int VEC>
int fwd(const int* ptr, const int* src, const float* a, const void* x, const void* w,
        const void* b, const void* t, float* aggr, float* lse, int num_dst, int D, int kind,
        cudaStream_t st) {
  const Plan p = make_plan<T, VEC>(num_dst, D, D);
  int grid = 0;
  const cudaError_t err = pick_grid(gen_agg_fwd_kernel<T, VEC>, kind, p.n_blocks,
                                    0x7fffffff, &grid);
  if (err != cudaSuccess) return err;
  gen_agg_fwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      ptr, src, a, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(t), aggr, lse, p);
  return cudaGetLastError();
}

template <typename T, int VEC>
int bwd(const int* ptr, const int* src, const float* a, const void* x, const void* w,
        const void* b, const void* t, const float* g, const float* aggr, const float* lse,
        void* dpre, int ld, float* part, int part_rows, float* out, int num_dst, int D,
        int kind, cudaStream_t st) {
  const Plan p = make_plan<T, VEC>(num_dst, D, ld);
  int grid = 0;
  cudaError_t err = pick_grid(gen_agg_bwd_kernel<T, VEC>, kind, p.n_blocks, part_rows, &grid);
  if (err != cudaSuccess) return err;
  gen_agg_bwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      ptr, src, a, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(t), g, aggr, lse, static_cast<T*>(dpre),
      part, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int cols = 2 * D + 1;
  gen_agg_reduce_kernel<<<(cols + 127) / 128, 128, 0, st>>>(part, grid, cols, out);
  return cudaGetLastError();
}

}  // namespace

// Forward. dtype: 0 = fp32, 1 = bf16 (x, w, b and t); ptr (num_dst+1) and
// src (E) int32, a (E) fp32, x (num_src, D), w and b (D), t one element;
// aggr and lse (num_dst, D) fp32, all contiguous. The kernel reads 16-byte
// pieces where D is a multiple of 4 (fp32) or 8 (bf16) and x, w, b, aggr and
// lse are 16-byte aligned, else one element at a time. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int lp_gen_agg_fwd(const void* ptr, const void* src, const void* a,
                              const void* x, const void* w, const void* b, const void* t,
                              void* aggr, void* lse, int num_dst, int D, int dtype,
                              void* stream) {
  if (num_dst <= 0 || D <= 0) return cudaErrorInvalidValue;
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
      return fwd<float, 4>(p, s, av, x, w, b, t, ag, ls, num_dst, D, 0, st);
    return fwd<float, 1>(p, s, av, x, w, b, t, ag, ls, num_dst, D, 1, st);
  }
  if (dtype == 1) {
    if (al && D % 8 == 0)
      return fwd<__nv_bfloat16, 8>(p, s, av, x, w, b, t, ag, ls, num_dst, D, 2, st);
    return fwd<__nv_bfloat16, 1>(p, s, av, x, w, b, t, ag, ls, num_dst, D, 3, st);
  }
  return cudaErrorInvalidValue;
}

// Backward. The forward's arguments, then g, aggr, lse (num_dst, D) fp32;
// dpre (E, ld) of x's type, ld >= D, its columns D..ld-1 zero-filled by the
// caller and left alone; part, a workspace of part_rows x (2D+1) fp32
// (part_rows >= 1 bounds the grid); out (2D+1) fp32 receives dw, db, dt.
// Returns as lp_gen_agg_fwd.
extern "C" int lp_gen_agg_bwd(const void* ptr, const void* src, const void* a,
                              const void* x, const void* w, const void* b, const void* t,
                              const void* g, const void* aggr, const void* lse, void* dpre,
                              int ld, void* part, int part_rows, void* out, int num_dst,
                              int D, int dtype, void* stream) {
  if (num_dst <= 0 || D <= 0 || ld < D || part_rows <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(src);
  const float* av = static_cast<const float*>(a);
  const float* gv = static_cast<const float*>(g);
  const float* ag = static_cast<const float*>(aggr);
  const float* ls = static_cast<const float*>(lse);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const bool al = aligned16(x) && aligned16(w) && aligned16(b) && aligned16(g) &&
                  aligned16(aggr) && aligned16(lse) && aligned16(dpre);
  if (dtype == 0) {
    if (al && D % 4 == 0 && ld % 4 == 0)
      return bwd<float, 4>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, pt, part_rows, o,
                           num_dst, D, 4, st);
    return bwd<float, 1>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, pt, part_rows, o,
                         num_dst, D, 5, st);
  }
  if (dtype == 1) {
    if (al && D % 8 == 0 && ld % 8 == 0)
      return bwd<__nv_bfloat16, 8>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, pt, part_rows,
                                   o, num_dst, D, 6, st);
    return bwd<__nv_bfloat16, 1>(p, s, av, x, w, b, t, gv, ag, ls, dpre, ld, pt, part_rows, o,
                                 num_dst, D, 7, st);
  }
  return cudaErrorInvalidValue;
}
