// Row gather for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
//   out[k, :] = table[idx[k], :]
//
// Replaces the four TPU VMEM-gather probes: scripts/probe_vmem_gather.py:51
// vmem_gather_kernel and :72 vmem_gather_loop_kernel, and
// scripts/probe_vmem_gather2.py:54 k_take_along and :60 k_vector_index.
// All four compute this one function (the probes differ only in how Mosaic
// lowers the in-kernel gather from a VMEM-resident table). They measured
// the cost of the row gather of source features that the SpMM is made of;
// chip_smoke.py times this kernel beside lp_gnn_tpu_torch/ops/csrc/spmm.cu.
//
// Types: idx int32 (K,), table (S, D) and out (K, D), any element type of
// 2 or 4 bytes (fp32, bf16), contiguous. The kernel copies bytes and does no
// arithmetic.
//
// Bound: bytes only. K*4 (idx) + S_used*D*b (table rows some index
// references, read once) + K*D*b (out), over 3.35 TB/s. The kernel reads a
// table row once per index (K*D*b), so it reaches that bound only where L2
// holds the table (S=8192, D=256 bf16 is 4 MiB) and is bound by the gather
// traffic otherwise.
//
// Design: each thread copies one 16-byte piece of one output row (4- or
// 2-byte pieces where the row width or the pointers do not allow 16), so a
// warp reads neighbouring pieces of a source row and writes neighbouring
// pieces of an output row; the grid strides over the K * pieces work items.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ idx, const W* __restrict__ table,
                   W* __restrict__ out, long long total, int pieces) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += stride) {
    const long long k = t / pieces;
    const int p = static_cast<int>(t - k * pieces);
    const int s = __ldg(idx + k);
    out[t] = __ldg(table + static_cast<long long>(s) * pieces + p);
  }
}

template <typename W>
cudaError_t launch(const int* idx, const void* table, void* out, int K, long long row_bytes,
                   cudaStream_t stream) {
  const int pieces = static_cast<int>(row_bytes / sizeof(W));
  const long long total = static_cast<long long>(K) * pieces;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks an SM
  gather_rows_kernel<W><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      idx, static_cast<const W*>(table), static_cast<W*>(out), total, pieces);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 or 4. Returns cudaGetLastError() after the launch.
extern "C" int lp_gather_rows(const void* idx, const void* table, void* out, int K, int D,
                              int elem_bytes, void* stream) {
  if (K <= 0 || D <= 0 || (elem_bytes != 2 && elem_bytes != 4)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(D) * elem_bytes;
  const int* i = static_cast<const int*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0 && row_bytes % 16 == 0) return launch<uint4>(i, table, out, K, row_bytes, st);
  if (align % 4 == 0 && row_bytes % 4 == 0) return launch<unsigned int>(i, table, out, K, row_bytes, st);
  return launch<unsigned short>(i, table, out, K, row_bytes, st);
}
