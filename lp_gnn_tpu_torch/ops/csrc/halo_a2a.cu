// Halo all-to-all for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
//   out[q][p*Bh : (p+1)*Bh, :] = in[p][q*Bh : (q+1)*Bh, :]    for p, q < K
//
// Replaces lp_gnn_tpu/parallel/pallas_halo.py:39 _a2a_kernel (called by :69
// pallas_all_to_all), the halo exchange of the edge-partitioned forward
// (lp_gnn_tpu/parallel/edge_partition.py:572 _halo_a2a), which equals
// lax.all_to_all(x, ax, 0, 0, tiled=True): shard p's block q lands in shard
// q's block p. The TPU kernel posts one local DMA for its own block and K-1
// remote DMAs over ICI. Here the K shards' buffers are K device pointers
// in a table passed by value, so one launch moves all K*K blocks, the
// diagonal ones included (as the TPU kernel's local DMA copies its own
// block). Two entries fill the table: the stacked form, from the bases of
// two (K, K*Bh, F) tensors (the reduce direction of the edge-partitioned
// forward, all shards on one card), and the list form, from K addresses
// each.
//
// The rank form (lp_halo_a2a_rank) is the TPU kernel's own shape: this
// process holds shard `me` of K, one process a shard, and writes its K
// blocks straight into the K receive windows, block p at slot `me` of shard
// p's window: dst[p][me*Bh : (me+1)*Bh, :] = src[p*Bh : (p+1)*Bh, :]. Its
// own window stands for the TPU kernel's local DMA, the K-1 peers' windows
// (cudaMalloc'ed by their processes, exported with cudaIpcGetMemHandle and
// opened here with cudaIpcOpenMemHandle) for make_async_remote_copy into
// peer p's slot `me` (pallas_halo.py:54-62). Peers that share this card are
// written in its memory; peers on other cards of the host over NVLink, by
// the same stores. The TPU kernel's semaphores are the caller's: a barrier
// over the ranks before the launch (no rank still reads its window), a
// stream synchronise and a swap of the ranks' error codes after it (every
// write landed); then the caller copies its own window out with the list
// form (K=1). The window entries below allocate, export, open, close and
// free the windows; the caller swaps the 64-byte handles between the ranks.
//
// Types: each block is Bh rows of F elements, contiguous, so a block is one
// contiguous run of Bh*F*b bytes in its source and in its destination. The
// kernel copies bytes (fp32 or bf16 alike) and does no arithmetic. Every
// pointer must be 16-byte aligned and the block size a multiple of 16 bytes;
// the caller checks both, and the launcher refuses anything else.
//
// Bound: bytes only. Each input byte read once and each output byte written
// once, 2*K*K*Bh*F*b, over 3.35 TB/s. At the bench graph's halo (K=4,
// Bh=30,056) that is 1.97 GB and about 0.59 ms at F=1024 bf16. A rank's
// launch moves 2*K*Bh*F*b of it (0.147 ms there), and its copy-out as much
// again: 4*K*Bh*F*b a rank an exchange.
//
// Design against that bound: 16-byte loads and stores, neighbouring threads
// on neighbouring 16-byte pieces, 4 independent loads in flight a thread
// before its stores. The grid is (row pieces, source block p, destination
// shard q): blockIdx.y and blockIdx.z pick one block pair, blockIdx.x
// strides over its pieces. No shared memory, no synchronisation. The rank
// form runs the same kernel over a grid of one source: (pieces, 1, K).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxShards = 64;
constexpr long long kMaxBlocks = 132LL * 32;  // 32 blocks of 256 an SM, 2 waves

struct Table {
  const uint4* src[kMaxShards];  // src[p]: shard p's (K*Bh, F) buffer
  uint4* dst[kMaxShards];        // dst[q]: shard q's (K*Bh, F) buffer
};

__global__ void __launch_bounds__(kThreads)
halo_a2a_kernel(const __grid_constant__ Table t, long long n16) {
  const int p = blockIdx.y;
  const int q = blockIdx.z;
  const uint4* __restrict__ s = t.src[p] + static_cast<long long>(q) * n16;
  uint4* __restrict__ d = t.dst[q] + static_cast<long long>(p) * n16;
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  const long long stride = static_cast<long long>(gridDim.x) * tile;
  for (long long base = static_cast<long long>(blockIdx.x) * tile + threadIdx.x; base < n16;
       base += stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < n16) v[u] = __ldg(s + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < n16) d[i] = v[u];
    }
  }
}

// One launch over the (source p < P, destination q < K) block pairs of the
// shards in `t`: P = K for the stacked and list forms, 1 for the rank form.
int launch(const Table& t, int P, int K, long long block_bytes, cudaStream_t stream) {
  const long long n16 = block_bytes / 16;
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  long long gx = (n16 + tile - 1) / tile;
  const long long cap = kMaxBlocks / (static_cast<long long>(P) * K);
  if (gx > cap) gx = cap > 0 ? cap : 1;
  const dim3 grid(static_cast<unsigned>(gx), P, K);
  halo_a2a_kernel<<<grid, kThreads, 0, stream>>>(t, n16);
  return cudaGetLastError();
}

bool takes(int K, long long block_bytes) {
  return K >= 1 && K <= kMaxShards && block_bytes > 0 && block_bytes % 16 == 0;
}

bool aligned(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

}  // namespace

// The launching entries return cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not
// take; the caller raises on anything but 0. Every address must be 16-byte
// aligned and a block a positive multiple of 16 bytes, 1 <= K <= 64.

// The list form: src, dst are K device pointers each, shard p's (K*Bh, F)
// buffer at src[p], shard q's at dst[q]; each buffer holds K blocks of
// block_bytes. Takes any K addresses the device can reach.
extern "C" int lp_halo_a2a(const void* const* src, void* const* dst, int K,
                           long long block_bytes, void* stream) {
  if (!takes(K, block_bytes)) return cudaErrorInvalidValue;
  Table t = {};
  for (int i = 0; i < K; ++i) {
    if (!aligned(src[i], dst[i])) return cudaErrorInvalidValue;
    t.src[i] = static_cast<const uint4*>(src[i]);
    t.dst[i] = static_cast<uint4*>(dst[i]);
  }
  return launch(t, K, K, block_bytes, static_cast<cudaStream_t>(stream));
}

// The stacked form: the K buffers of each side lie buf_bytes apart from
// src_base and dst_base (one (K, K*Bh, F) tensor each), so the pointer table
// is built here and the caller passes no array.
extern "C" int lp_halo_a2a_stacked(const void* src_base, void* dst_base, int K,
                                   long long buf_bytes, long long block_bytes, void* stream) {
  if (!takes(K, block_bytes) || buf_bytes < K * block_bytes || buf_bytes % 16 != 0 ||
      !aligned(src_base, dst_base))
    return cudaErrorInvalidValue;
  Table t = {};
  for (int i = 0; i < K; ++i) {
    t.src[i] = reinterpret_cast<const uint4*>(static_cast<const char*>(src_base) + i * buf_bytes);
    t.dst[i] = reinterpret_cast<uint4*>(static_cast<char*>(dst_base) + i * buf_bytes);
  }
  return launch(t, K, K, block_bytes, static_cast<cudaStream_t>(stream));
}

// The rank form: src is this shard's (K*Bh, F) buffer, dst[p] shard p's
// receive window as this process reaches it (dst[me] its own, the others
// IPC mappings); block p of src lands at block `me` of dst[p]. One launch
// over K blocks, grid (pieces, 1, K).
extern "C" int lp_halo_a2a_rank(const void* src, void* const* dst, int me, int K,
                                long long block_bytes, void* stream) {
  if (!takes(K, block_bytes) || me < 0 || me >= K) return cudaErrorInvalidValue;
  Table t = {};
  t.src[0] = static_cast<const uint4*>(src);
  for (int q = 0; q < K; ++q) {
    if (!aligned(src, dst[q])) return cudaErrorInvalidValue;
    t.dst[q] = reinterpret_cast<uint4*>(static_cast<char*>(dst[q]) + me * block_bytes);
  }
  return launch(t, 1, K, block_bytes, static_cast<cudaStream_t>(stream));
}

// Receive windows for the rank form. Each returns the CUDA error (0 = done).
// A window is a whole cudaMalloc allocation, since an IPC handle names the
// base of one; handles are opaque bytes (lp_halo_ipc_handle_bytes of them).

extern "C" int lp_halo_ipc_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// Allocate `bytes` on the current device into *ptr and write its handle.
extern "C" int lp_halo_window_alloc(long long bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return e;
  }
  memcpy(handle, &h, sizeof h);
  return cudaSuccess;
}

// Map a peer's window (its handle) into this process at *ptr. The exporting
// process cannot open its own handle.
extern "C" int lp_halo_window_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  *ptr = nullptr;
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int lp_halo_window_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

extern "C" int lp_halo_window_free(void* ptr) { return cudaFree(ptr); }
