// Row gather for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
//   out[k, :] = table[idx[k], :]
//
// Replaces the four TPU VMEM-gather probes: scripts/probe_vmem_gather.py:51
// vmem_gather_kernel and :72 vmem_gather_loop_kernel, and
// scripts/probe_vmem_gather2.py:54 k_take_along and :60 k_vector_index.
// All four compute this one function (the probes differ only in how Mosaic
// lowers the in-kernel gather from a VMEM-resident table). On the card it
// is the gather direction of the edge-partitioned halo exchange: one launch
// over a composed index writes every shard's halo buffer
// (lp_gnn_tpu_torch/parallel/edge_partition.py halo_gather).
//
// Types: idx int32 (K,), table (S, D) and out (K, D), any element type of
// 2 or 4 bytes (fp32, bf16), contiguous. The kernel copies bytes and does no
// arithmetic.
//
// Bound: bytes only. K*4 (idx) + S_used*D*b (table rows some index
// references, read once) + K*D*b (out), over 3.35 TB/s. A table row that
// several indices reference is read from device memory once only where L2
// still holds it at its next use; otherwise the kernel is bound by
// K*4 + 2*K*D*b (the no-reuse form).
//
// Design against that bound:
// - A group of G lanes copies one output row, G the power of two that covers
//   the row's pieces, at most a warp. Pieces are 16 bytes, or 4 or 2 where
//   the row width or the pointers do not allow 16. D=8 bf16 is one piece and
//   one lane a row; D=1024 bf16 is 128 pieces, a warp a row, 4 pieces a lane.
// - A warp loads the indices of 32 (or 64, 128) consecutive rows at once,
//   one a lane, coalesced, and hands each row's index to its group with a
//   shuffle: every index is read once, and nothing is divided per piece.
// - Each lane has 4 independent loads in flight before its 4 stores: one
//   piece of 4 rows, 2 pieces of 2 rows, or 4 pieces of one row. Rows wider
//   than a warp's 4 pieces a lane are walked in slabs of that width.
// - Stores carry the streaming hint (st.global.cs): the output is written
//   once and not read here, so L2 evicts it first and keeps the table.
// - A warp copies one range of output rows at a time. By default the
//   ranges are the rows in order, kChunk at a time. A caller may instead
//   hand over its own list of ranges (`sched`), in the order the work
//   should go. The edge-partitioned halo gather does: its composed index is
//   one sorted block per (receiver, sender) pair, and its schedule cuts
//   every block at the same sender-row windows and lists the pieces window
//   by window. The warps that read one window's rows for different
//   receivers then start together and step through the same rows at the
//   same pace, so a sender row is read from device memory once and from L2
//   for its other receivers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond 32 blocks an SM

// Streaming stores (st.global.cs: evict first from L2), one per piece width.
__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void store_stream(unsigned int* p, unsigned int v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void store_stream(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(v) : "memory");
}

// G lanes a row, up to kPer pieces a lane in each slab of G*kPer pieces.
// The warp's work is ranges of output rows: sched[e] = (first row, rows),
// or, with no schedule, the rows in order kChunk at a time.
template <typename W, int G, int kPer>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ idx, const W* __restrict__ table,
                   W* __restrict__ out, int K, const int2* __restrict__ sched,
                   int n_ranges, int pieces) {
  constexpr int kGroups = 32 / G;                  // rows a warp copies side by side
  constexpr int kRows = kPer >= 4 ? 1 : 4 / kPer;  // rows a group copies at once
  constexpr int kBatch = kGroups * kRows;          // rows a warp copies at once
  constexpr int kChunk = kBatch > 32 ? kBatch : 32;  // rows whose indices a warp loads
  constexpr int kRegs = kChunk / 32;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two <= 32");
  static_assert(kChunk % kBatch == 0, "a chunk is whole batches");

  const int lane = threadIdx.x & 31;
  const int g = lane / G;
  const int p0 = lane % G;
  // K < 2^31 rows, so range and row numbers fit an int; only element
  // offsets need 64 bits
  const int stride = gridDim.x * kWarps;
  for (int e = blockIdx.x * kWarps + (threadIdx.x >> 5); e < n_ranges; e += stride) {
    int start = e * kChunk, len = K - start < kChunk ? K - start : kChunk;
    if (sched != nullptr) {
      const int2 r = __ldg(sched + e);
      start = r.x;
      len = r.y;
    }
    for (int first = start; first < start + len; first += kChunk) {  // warp-uniform
      const int n = start + len - first < kChunk ? start + len - first : kChunk;
      int mine[kRegs];
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const int i = r * 32 + lane;
        mine[r] = i < n ? __ldg(idx + first + i) : 0;
      }
      for (int b = 0; b < kChunk / kBatch; ++b) {
        int src[kRows];
        int row[kRows];   // row within the chunk
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int pos = (b * kRows + u) * kGroups + g;
          // with kRegs > 1 there is one batch a chunk, and (u*kGroups)/32
          // is the register that holds position pos (kGroups is 16 or 32)
          src[u] = __shfl_sync(0xffffffffu, mine[kRegs == 1 ? 0 : (u * kGroups) / 32],
                               pos & 31);
          row[u] = pos;
        }
        for (int q0 = 0; q0 < pieces; q0 += G * kPer) {
          W v[kRows][kPer];
#pragma unroll
          for (int u = 0; u < kRows; ++u)
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int p = q0 + p0 + i * G;
              if (row[u] < n && p < pieces)
                v[u][i] = __ldg(table + static_cast<long long>(src[u]) * pieces + p);
            }
#pragma unroll
          for (int u = 0; u < kRows; ++u)
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int p = q0 + p0 + i * G;
              if (row[u] < n && p < pieces)
                store_stream(out + static_cast<long long>(first + row[u]) * pieces + p,
                             v[u][i]);
            }
        }
      }
    }
  }
}

template <typename W, int G, int kPer>
cudaError_t launch(const int* idx, const void* table, void* out, int K, const int2* sched,
                   int n_sched, int pieces, cudaStream_t stream) {
  constexpr int kRows = kPer >= 4 ? 1 : 4 / kPer;
  constexpr int kBatch = (32 / G) * kRows;
  constexpr int kChunk = kBatch > 32 ? kBatch : 32;
  const int n_ranges = sched != nullptr ? n_sched : (K - 1) / kChunk + 1;
  long long grid = (static_cast<long long>(n_ranges) + kWarps - 1) / kWarps;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  gather_rows_kernel<W, G, kPer><<<static_cast<int>(grid), kThreads, 0, stream>>>(
      idx, static_cast<const W*>(table), static_cast<W*>(out), K, sched, n_ranges, pieces);
  return cudaGetLastError();
}

// The group and slab shape for rows of `pieces` pieces of W.
template <typename W>
cudaError_t dispatch(const int* idx, const void* table, void* out, int K, const int2* sched,
                     int n_sched, int pieces, cudaStream_t st) {
  if (pieces == 1) return launch<W, 1, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 2) return launch<W, 2, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 4) return launch<W, 4, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 8) return launch<W, 8, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 16) return launch<W, 16, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 32) return launch<W, 32, 1>(idx, table, out, K, sched, n_sched, pieces, st);
  if (pieces <= 64) return launch<W, 32, 2>(idx, table, out, K, sched, n_sched, pieces, st);
  return launch<W, 32, 4>(idx, table, out, K, sched, n_sched, pieces, st);
}

}  // namespace

// sched: null (rows in order), or n_sched (first row, rows) pairs of int32,
// 8-byte aligned, that cover each of the K rows once. elem_bytes: 2 or 4.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take; the caller
// raises on anything but 0.
extern "C" int lp_gather_rows(const void* idx, const void* table, void* out, int K, int D,
                              int elem_bytes, const void* sched, int n_sched, void* stream) {
  if (K <= 0 || D <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (sched != nullptr && (n_sched <= 0 || reinterpret_cast<uintptr_t>(sched) % 8 != 0)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(D) * elem_bytes;
  const int* i = static_cast<const int*>(idx);
  const int2* sc = static_cast<const int2*>(sched);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0 && row_bytes % 16 == 0)
    return dispatch<uint4>(i, table, out, K, sc, n_sched, static_cast<int>(row_bytes / 16), st);
  if (align % 4 == 0 && row_bytes % 4 == 0)
    return dispatch<unsigned int>(i, table, out, K, sc, n_sched,
                                  static_cast<int>(row_bytes / 4), st);
  return dispatch<unsigned short>(i, table, out, K, sc, n_sched,
                                  static_cast<int>(row_bytes / 2), st);
}
