// CSR SpMM for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
//   out[d, :] = sum_{e in [ptr[d], ptr[d+1])} val[e] * x[idx[e], :]
//
// Replaces lp_gnn_tpu/ops/spmm.py:77 blocked_spmm (and its oracle :34
// segment_spmm), the bipartite aggregation of every GraphConv layer. The
// JAX package lowers it through XLA as a one-hot MXU contraction over
// chunked edge blocks; that layout exists for the TPU's matrix unit and
// has no counterpart here. On the H100 the same sum is a sorted segment
// reduction: one group of lanes per destination row walks the row's edges
// in order and keeps the row's sum in registers.
//
// Both directions of the two-tower conv use this one kernel: the CSR of the
// row-sorted ordering for vars -> cons, the CSC of the col-sorted ordering
// for cons -> vars (lp_gnn_tpu_torch/data/graph.py).
//
// Types: x and out are fp32 or bf16, (S, D) and (num_dst, D), contiguous
// and 16-byte aligned, with D a multiple of one 16-byte piece (4 fp32, 8
// bf16) and at most 256 pieces (1024 fp32, 2048 bf16): the path's widths
// are D=8 and D=1024. val is fp32; ptr and idx are int32. The sum is taken in fp32 (each
// product too, by fmaf) and rounded once to x's type, as blocked_spmm
// returns (ops/spmm.py:111-115). A row with no edges gives zeros. Each row
// is summed by one lane group in edge order: deterministic, no atomics.
//
// Bound. The least traffic is each input read once and the output written
// once: (num_dst+1)*4 (ptr) + E*8 (idx+val) + S_used*D*b (x rows that some
// edge references) + num_dst*D*b (out), over 3.35 TB/s. The kernel itself
// reads x once per edge, E*D*b bytes (no reuse assumed), and only L2 hits
// on repeated source rows bring it toward the first figure. 2*E*D flops in
// fp32 are far below the card's fp32 rate at either width of the path
// (D=8, D=1024): the kernel is bound by bytes.
//
// Design against that bound. The gather of x rows is the traffic, so each
// load is 16 bytes a lane (float4 / 8 bf16) and neighbouring lanes read
// neighbouring 16-byte pieces of one source row: a wide row (D=1024) is
// read by a full warp with 8 (fp32) or 4 (bf16) loads in flight per lane
// and edge. A narrow row (D=8) is one or two 16-byte pieces, so 32 or 16
// rows share a warp and no lane idles. The group loads G edges' (idx, val)
// at once, one per lane, coalesced, and broadcasts them by shuffle, so the
// index stream is read once per row. Later work (not here): stage the index
// stream in shared memory with cp.async, and reuse source rows across
// destination rows through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Load-multiply-accumulate and store of VEC consecutive elements.
template <typename T, int VEC> struct Io;

template <> struct Io<float, 4> {
  static __device__ __forceinline__ void fma(float* acc, const float* p, float w) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <> struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(float* acc, const __nv_bfloat16* p, float w) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* acc) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// One group of G lanes (G a power of two, <= 32) per destination row. Lane
// gl of the group owns the VEC-wide pieces gl, gl+G, ..., gl+(NV-1)*G of
// the row; the launcher picks G*NV >= D/VEC, so one pass covers the row.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ val, const T* __restrict__ x,
                T* __restrict__ out, int num_dst, int D, int G) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int row = tid / G;
  const int gl = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
  const unsigned mask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
  const bool active = row < num_dst;
  const int start = active ? __ldg(ptr + row) : 0;
  const int end = active ? __ldg(ptr + row + 1) : 0;
  const int nvec = D / VEC;

  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;

  for (int e0 = start; e0 < end; e0 += G) {
    int my_s = 0;
    float my_w = 0.f;
    if (e0 + gl < end) {
      my_s = __ldg(idx + e0 + gl);
      my_w = __ldg(val + e0 + gl);
    }
    const int cnt = min(G, end - e0);
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const int s = __shfl_sync(mask, my_s, k, G);
      const float w = __shfl_sync(mask, my_w, k, G);
      const T* xs = x + static_cast<size_t>(s) * D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = gl + j * G;
        if (v < nvec) Io<T, VEC>::fma(acc[j], xs + v * VEC, w);
      }
    }
  }

  if (active) {
    T* o = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = gl + j * G;
      if (v < nvec) Io<T, VEC>::store(o + v * VEC, acc[j]);
    }
  }
}

// D a multiple of VEC and at most kMaxPieces * VEC; x and out 16-byte aligned.
constexpr int kMaxPieces = 32 * 8;

template <typename T, int VEC>
cudaError_t launch(const int* ptr, const int* idx, const float* val, const void* x, void* out,
                   int num_dst, int D, cudaStream_t stream) {
  const int nvec = D / VEC;
  if (D % VEC != 0 || nvec > kMaxPieces ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  // NV pieces a lane, the fewest (up to 8) with which a warp covers the
  // row; then the smallest group that covers it
  int nv = 1;
  while (nv < 8 && nv * 32 < nvec) nv *= 2;
  int g = 1;
  while (g < 32 && g * nv < nvec) g *= 2;
  const int rows_per_block = kThreads / g;
  if (num_dst > (0x7fffffff - kThreads) / g) return cudaErrorInvalidValue;
  const int blocks = (num_dst + rows_per_block - 1) / rows_per_block;
  const T* xx = static_cast<const T*>(x);
  T* oo = static_cast<T*>(out);
  switch (nv) {
    case 1: spmm_csr_kernel<T, VEC, 1><<<blocks, kThreads, 0, stream>>>(ptr, idx, val, xx, oo, num_dst, D, g); break;
    case 2: spmm_csr_kernel<T, VEC, 2><<<blocks, kThreads, 0, stream>>>(ptr, idx, val, xx, oo, num_dst, D, g); break;
    case 4: spmm_csr_kernel<T, VEC, 4><<<blocks, kThreads, 0, stream>>>(ptr, idx, val, xx, oo, num_dst, D, g); break;
    default: spmm_csr_kernel<T, VEC, 8><<<blocks, kThreads, 0, stream>>>(ptr, idx, val, xx, oo, num_dst, D, g); break;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (D a multiple of 4, at most 1024), 1 = bf16 (D a multiple
// of 8, at most 2048); x and out 16-byte aligned. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take; the caller raises on anything but 0.
extern "C" int lp_spmm_csr(const void* ptr, const void* idx, const void* val,
                           const void* x, void* out, int num_dst, int D, int dtype,
                           void* stream) {
  if (num_dst <= 0 || D <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(val);
  if (dtype == 0) return launch<float, 4>(p, i, v, x, out, num_dst, D, st);
  if (dtype == 1) return launch<__nv_bfloat16, 8>(p, i, v, x, out, num_dst, D, st);
  return cudaErrorInvalidValue;
}
