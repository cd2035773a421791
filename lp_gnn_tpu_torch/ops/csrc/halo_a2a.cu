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
// The device form (lp_halo_devices_exchange) is the TPU kernel's remote
// copy (pallas_halo.py:54 make_async_remote_copy in :39 _a2a_kernel, via
// :69) with every shard in one process, shard d on device d: the launch of
// source d runs on device d's stream and writes its K blocks straight into
// the K destination buffers, each on its own device (its own card, over
// NVLink, or this card), through peer pointers, which needs peer access
// from every source card to every destination card (lp_halo_peer_enable,
// one ordered pair). Its bound across cards is the NVLink bytes, 3 blocks a
// card out and 3 in at K=4 (about 450 GB/s one way on an H100 SXM); on one
// card it is the stacked form's bytes over the memory rate. What the design
// does about them:
// - Staggered destinations, as the TPU kernel posts its remote copies
//   (pallas_halo.py:47-62: at offset s, device me sends to (me + s) mod K,
//   "so the ICI links run concurrently"). A launch's CTAs take the remote
//   pairs round robin, the destination the fastest-varying part of the
//   block index, in the order (me + 1, ..., me + K - 1) mod K: every wave
//   of every source stores to all K - 1 peers at once, and each card
//   receives from every source at once, where a grid (pieces, 1, K), the
//   destination the slowest-varying part, sends a source's blocks to one
//   destination after another, every source to the same one at the same
//   time (PERF.md: 248 against 341 GB/s a card over 4 H100s). The local pair (no link) has
//   CTAs of its own after the remote ones, so it takes no share of the
//   first wave's dispatch.
// - A grid sized for what shares the card: a launch takes one wave of
//   resident CTAs divided by the streams that launch at once on its card
//   (the caller's `share`), so K launches on one card fill one wave
//   together rather than queueing K waves, and a source with a card of its
//   own keeps a whole wave. Each pair takes an equal part of the launch's CTAs (at least
//   one, at most its tiles).
// - 16-byte loads and stores, 4 loads in flight a thread before its stores
//   (8 measured no faster over 4 H100s: PERF.md).
// - One host call an exchange: the plan (devices, shares, destination
//   orders and the events) is made once, and lp_halo_devices_exchange
//   records, waits and launches the K sources back to back: each
//   destination stream records that its buffer exists, each writer waits
//   for the destinations' records and launches, each destination stream
//   waits for every writer. Per-launch CUDA events time each source's
//   kernel where asked (lp_halo_devices_times).
// The rank form's write (lp_halo_a2a_rank, below) is the same launch over
// its K windows, a whole wave (ranks that share a card time-share it: their
// launches do not run at once).

// The rank form (lp_halo_a2a_rank) is the TPU kernel's own shape: this
// process holds shard `me` of K, one process a shard, and writes its K
// blocks straight into the K receive windows, block p at slot `me` of shard
// p's window: dst[p][me*Bh : (me+1)*Bh, :] = src[p*Bh : (p+1)*Bh, :]. Its
// own window stands for the TPU kernel's local DMA, the K-1 peers' windows
// (cudaMalloc'ed by their processes, exported with cudaIpcGetMemHandle and
// opened here with cudaIpcOpenMemHandle) for make_async_remote_copy into
// peer p's slot `me` (pallas_halo.py:54-62). Peers that share this card are
// written in its memory; peers on other cards of the host over NVLink, by
// the same stores. A second kernel (lp_halo_copy_out) copies the rank's own
// window out into the result, which escapes into autograd.
//
// Two forms of the rank form, one a layout of ranks on one host; the ranks
// choose from their placement (mesh.py rank_form), never after a failure (a
// group over several hosts takes no form of this file: NCCL's all-to-all):
// - Ranks that time-share a card (more ranks of the world than cards): the
//   flags form, below: the write (lp_halo_a2a_rank) and the copy-out
//   (lp_halo_copy_out), ordered by flag words in host memory that each
//   rank's stream waits on and writes. No rank may spin on a time-shared
//   card: a spinning kernel holds its time slice while the peer it waits for
//   cannot run.
// - Ranks with a card each: the signalled form (lp_halo_rank_signalled), one
//   kernel an exchange whose signals are counters in the windows' own device
//   allocations, reached over NVLink, and whose copy-out of a peer's block
//   starts as soon as that block is whole. There no flag crosses PCIe and no
//   stream's front end polls host memory between two kernels; a spin costs
//   only the SMs it holds, on a card no other rank needs.
//
// The flags form's semaphores. The TPU kernel waits on send_sem / recv_sem /
// copy_sem, ordered across devices by collective_id (pallas_halo.py:78-80).
// Here they
// are flag words that the card waits on and writes, ordered on each rank's
// stream, so an exchange makes no host collective and no synchronise. Each
// rank's allocation holds two windows (exchange e uses window e mod 2), and
// each rank a header of 64-bit flags: for each window w, arrival[w][p] (the
// epoch of the last blocks rank p wrote here) and done[w][p] (the epoch rank
// p last finished reading its own window w, as this rank sees it). Exchange
// e on rank me, on its stream:
//   wait own done[w][p] >= e-2 for every peer p   (no peer still reads what
//                                                   exchange e overwrites)
//   lp_halo_a2a_rank: the K blocks into the K windows w
//   write arrival[w][me] = e into every peer's header        (send_sem)
//   wait own arrival[w][p] >= e for every peer p            (recv_sem)
//   lp_halo_copy_out: own window w into the result
//   write done[w][me] = e into every peer's header
// The epochs are host counters (every rank makes the same exchanges in the
// same order), passed by value to each wait and write, so a CUDA graph that
// captured an exchange would replay its epochs; keeping them in device
// memory would take a kernel a step, and no rank-form step is captured.
//
// Where the flags live. A header is a page of host memory that the ranks
// share (POSIX shared memory, named by its rank and opened by the others),
// registered in every rank's process as mapped pinned memory
// (lp_halo_flags_register), so that each card reaches every header and the
// host its own with plain loads and stores. A host store must be able to end
// a wait: a rank whose peer died ends its own stream's waits by writing an
// abort word into its header, from a watchdog thread, while its main thread
// may be held inside the driver (a synchronise, or a lazy module load, which
// waits for the context's streams to drain). There no CUDA call of the
// watchdog's returns, cudaStreamCreate and cudaStreamQuery included, and no
// write it enqueues runs, where a store to host memory ends the wait (an H100
// with four ranks on it; PERF.md, PR 18). Flags in the windows' device
// allocation could be written only through the card.
//
// How the card waits (the choice; its cost on an H100 in PERF.md, the row
// "K1, remote half"):
// stream memory operations, cuStreamWaitValue64 (GEQ) and
// cuStreamWriteValue64, reached through cudaGetDriverEntryPoint so that no
// library here links libcuda. A wait holds no SM: the stream's front end
// polls the word, and the ranks that time-share the card without MPS lose
// no time slice to a spinning kernel, which flags inside the kernels (a
// release store by the write's last CTA, an acquire spin in the copy-out)
// would cost. The default write carries a memory barrier before the flag
// (__threadfence_system's semantics, scoped to the stream), so the blocks
// the preceding kernel stored, here or over NVLink, land before the flag
// that announces them. Every wait is on this rank's own header; every write
// goes to a peer's.
//
// Errors. A rank whose launch or stream operation fails writes an abort
// word (bit 62 set, its rank in bits 32-61, the CUDA error below) into
// every peer's arrival and done words of both windows, on its stream, which
// releases every GEQ wait on it (the wait compares cyclically,
// (int64_t)(*word - value) >= 0, so the word stays below 2^63 to count as
// above every epoch), stores it into its own header, and raises. A copy-out
// that finds an abort word among its arrival words records it in a status
// word of pinned, mapped host memory, which the host reads without a
// synchronise at its next exchange and raises on. A rank that releases its
// windows on an error outside the exchanges stores its abort word into the
// peers' headers first. The window entries below allocate, export, open,
// close and free the windows; the caller swaps the 64-byte handles between
// the ranks.
//
// The signalled form (halo_rank_signalled_kernel, one launch an exchange
// over window w = e mod 2). Each rank's allocation holds its two windows
// and, after them, 64-bit counters in the flag header's layout: for window
// w, arrival[w][p] (the chunks rank p stored into this rank's window w,
// summed over every exchange so far) and done[w][p] (the chunks rank p has
// copied out of its window w that this rank wrote). A chunk is kChunk
// 16-byte pieces (16 KiB) of one block; a block of n16 pieces has
// ceil(n16 / kChunk) of them. The host keeps each window's running sum of
// chunks (the same on every rank: the same exchanges in the same order)
// and passes two targets by value: done_target, the sum before this
// exchange (every use of window w so far, exchange e - 2's included), and
// arrival_target = done_target + this exchange's chunks. Counters only grow,
// so there is no reset and no word reused (no ABA). Every CTA b of the grid
// (G CTAs) takes chunks b, b + G, ... of every block and goes through the
// TPU kernel's steps (pallas_halo.py:48-52, at offset s device me sends to
// (me + s) mod K):
//   for s = 1, ..., K - 1, destination q = (me + s) mod K:
//     wait until its own done[w][q] reaches done_target (rank q has read
//     what exchange e - 2 wrote there); store its chunks of block q into
//     slot me of q's window w over NVLink; publish them: the CTA's
//     barrier, then thread 0's fence and release add of its chunk count
//     into q's arrival[w][me] (fence.acq_rel.sys, red.release.sys, in q's
//     allocation);
//     then, while step s's blocks are on the links, copy out what step
//     s - 1 brought: an acquire spin on its own arrival[w][p] until
//     arrival_target, p = (me - s + 1) mod K (local memory), the copy of
//     slot p into the result, and the chunks read published into p's
//     done[w][me]; after step 1, its own block instead, straight from buf
//     into the result (no hop through the window, no wait);
//   last, the copy-out of step K - 1's source, (me + 1) mod K.
// At each step the K ranks' sends form a permutation (each card sends to
// one peer and receives from one), which a source's egress bounds as it
// bounds all K - 1 at once (PERF.md, PR 20: about 365 GB/s to one peer
// or three); so the copy-outs, but the last, overlap the links instead of
// following them. Each CTA stores before it waits, a wait only ever waits
// for stores of an earlier step, and the grid is at most one wave of
// resident CTAs over the streams that launch at once on the card
// (`share`), so no spin waits for a CTA that is not resident. The spins
// also look out for this rank's K abort words (its flag header's
// arrival[w][*] in host memory, where a peer's abort and the watchdog's
// deadline word land, as in the flags form): one spinning CTA reads them
// a slot of the global timer and passes what it finds to the others
// through a word of the rank's own allocation (wait_for); a CTA that sees
// an abort word records it in *status and leaves the kernel (its later
// work too).
// Bound: the NVLink bytes a card sends, (K - 1) blocks (about 450 GB/s one
// way on an H100 SXM); the local bytes (K blocks read and written, K - 1
// received) overlap them.
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
// form's copy-out is the same loop over one block, plus one thread's look
// at K flag words. The device form's and the rank form's write
// (halo_pairs_kernel) is the same copy over a list of block pairs on a
// one-dimensional grid, as above.

#include <cuda.h>  // types and flags of the stream memory operations only
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxShards = 64;
constexpr long long kMaxBlocks = 132LL * 32;  // 32 blocks of 256 an SM, 2 waves
constexpr unsigned long long kAbort = 1ULL << 62;  // halo.py ABORT

struct Table {
  const uint4* src[kMaxShards];  // src[p]: shard p's (K*Bh, F) buffer
  uint4* dst[kMaxShards];        // dst[q]: shard q's (K*Bh, F) buffer
};

// This block's share of one contiguous copy of n16 16-byte pieces: 4 loads
// in flight a thread before its stores, the grid's x dimension striding.
__device__ __forceinline__ void copy_pieces(const uint4* __restrict__ s, uint4* __restrict__ d,
                                            long long n16) {
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

__global__ void __launch_bounds__(kThreads)
halo_a2a_kernel(const __grid_constant__ Table t, long long n16) {
  const int p = blockIdx.y;
  const int q = blockIdx.z;
  copy_pieces(t.src[p] + static_cast<long long>(q) * n16,
              t.dst[q] + static_cast<long long>(p) * n16, n16);
}

// The device form's block pairs: src[j] -> dst[j], n16 pieces each.
struct Pairs {
  const uint4* src[kMaxShards];
  uint4* dst[kMaxShards];
};

// Chunks c0, c0 + stride, ... of one pair's copy, a chunk kThreads * kUnroll
// pieces: kUnroll loads in flight a thread before its stores. kNc: the
// source does not change while the kernel runs (read through the
// non-coherent path); else plain loads, for a window that peers write
// during the kernel (read after an acquire).
template <bool kNc = true>
__device__ __forceinline__ void copy_chunks(const uint4* __restrict__ s, uint4* __restrict__ d,
                                            long long n16, long long c0, long long stride) {
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long base = c0 * tile + threadIdx.x; base < n16; base += stride * tile) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < n16) v[u] = kNc ? __ldg(s + i) : s[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < n16) d[i] = v[u];
    }
  }
}

// per_pair CTAs a pair: the first n_inter pairs take blocks round robin
// (block b: pair b mod n_inter, its chunk b / n_inter), the rest after them
// in the same way among themselves.
__global__ void __launch_bounds__(kThreads)
halo_pairs_kernel(const __grid_constant__ Pairs t, int n_inter, int n_pairs, long long n16,
                  int per_pair) {
  const int b = blockIdx.x;
  const int head = n_inter * per_pair;
  int j, c;
  if (b < head) {
    j = b % n_inter;
    c = b / n_inter;
  } else {
    const int rest = n_pairs - n_inter;
    j = n_inter + (b - head) % rest;
    c = (b - head) / rest;
  }
  copy_chunks(t.src[j], t.dst[j], n16, c, per_pair);
}

// The rank form's copy-out: own window -> result. The stream waited for
// every peer's arrival word before it; thread 0 of block 0 looks for an
// abort word among them and records the first in *status (host memory),
// unless one is there already. The copy runs either way.
__global__ void __launch_bounds__(kThreads)
halo_copy_out_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16,
                     const unsigned long long* arrival, int K, unsigned long long* status) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int p = 0; p < K; ++p) {
      const unsigned long long v = *static_cast<const volatile unsigned long long*>(arrival + p);
      if (v & kAbort) {
        volatile unsigned long long* st = status;
        if (*st == 0) *st = v;
        __threadfence_system();
        break;
      }
    }
  }
  copy_pieces(src, dst, n16);
}

// ------------------------------------------------------ the signalled form
constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll;  // pieces a chunk
constexpr int kSlotShift = 16;        // a slot of the abort look-out: 2^16 ns (65.5 us)
constexpr unsigned kMaxBackoff = 1024;  // ns between polls of a counter, at most

struct RankArgs {
  const uint4* src;         // this rank's (K*Bh, F) buffer
  uint4* out;               // its result
  char* base[kMaxShards];   // rank p's allocation as this rank reaches it
  long long window_bytes;   // a window; the counters follow the two windows
  long long n16;            // pieces a block
  const unsigned long long* aborts;  // this rank's K abort words (host-mapped)
  unsigned long long* status;        // where an abort word seen is recorded
  unsigned long long arrival_target, done_target;
  int me, K, w;
};

__device__ __forceinline__ uint4* window_of(char* base, long long window_bytes, int w) {
  return reinterpret_cast<uint4*>(base + w * window_bytes);
}

// arrival[w][p] and done[w][p] of the allocation at `base`
__device__ __forceinline__ unsigned long long* counter(char* base, long long window_bytes, int w,
                                                       int done, int p) {
  return reinterpret_cast<unsigned long long*>(base + 2 * window_bytes) +
         (2 * w + done) * kMaxShards + p;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The CTA's chunks (stored into a peer's window, or read out of this rank's)
// published as n more on `word`: the CTA's barrier orders every thread's
// accesses before thread 0's, whose fence and release add at system scope
// are cumulative over them.
__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long n) {
  __syncthreads();
  if (threadIdx.x == 0 && n > 0)
    asm volatile("fence.acq_rel.sys;\n\tred.release.sys.global.add.u64 [%0], %1;" ::"l"(word),
                 "l"(n)
                 : "memory");
}

// Thread 0 spins until *word >= target, with a backoff from 32 to
// kMaxBackoff ns between polls. The host's abort words lie in host memory,
// and reads of it from every spinning CTA slowed the exchange about
// fivefold over 4 H100s (PERF.md, PR 21): so in each slot of 2^kSlotShift
// ns of the global timer only CTA (slot mod G) reads them, if it spins
// then, and passes an abort word it finds to the others through `local`,
// a word of this rank's own allocation that every poll reads (its own
// arrival counter of itself, which no rank signals). On an abort word
// thread 0 records it in *status (unless one is there) and in *seen.
// Returns, to every thread of the CTA, whether the CTA goes on (no abort
// seen, now or before).
__device__ bool wait_for(const unsigned long long* word, unsigned long long target,
                         const RankArgs& a, unsigned long long* seen) {
  if (threadIdx.x == 0 && *seen == 0) {
    volatile unsigned long long* local =
        counter(a.base[a.me], a.window_bytes, a.w, 0, a.me);
    unsigned long long last = ~0ULL;
    for (unsigned pause = 32; load_acquire_sys(word) < target;) {
      unsigned long long v = *local;
      const unsigned long long slot = global_ns() >> kSlotShift;
      if (v == 0 && slot != last && slot % gridDim.x == blockIdx.x) {
        last = slot;
        for (int p = 0; p < a.K && v == 0; ++p) {
          const unsigned long long h =
              *static_cast<const volatile unsigned long long*>(a.aborts + p);
          if (h & kAbort) v = h;
        }
        if (v) *local = v;
      }
      if (v) {
        *seen = v;
        volatile unsigned long long* st = a.status;
        if (*st == 0) *st = v;
        __threadfence_system();
        break;
      }
      __nanosleep(pause);
      if (pause < kMaxBackoff) pause *= 2;
    }
  }
  __syncthreads();
  const bool go = *seen == 0;
  __syncthreads();  // every thread read *seen before thread 0 may write it again
  return go;
}

// Chunks b, b + G, ... of one block (G the grid): what CTA b copies of
// every block, and their count.
__device__ __forceinline__ unsigned long long chunks_of_cta(long long b, long long G,
                                                            long long chunks) {
  return b < chunks ? static_cast<unsigned long long>((chunks - b + G - 1) / G) : 0;
}

// Slot p of this rank's window w into block p of the result, once p's
// arrival counter reads whole; then the chunks read are published into p's
// done counter. False where the CTA left on an abort word.
__device__ bool copy_out_slot(const RankArgs& a, int p, unsigned long long* seen) {
  char* own = a.base[a.me];
  const long long b = blockIdx.x, G = gridDim.x, n16 = a.n16;
  if (!wait_for(counter(own, a.window_bytes, a.w, 0, p), a.arrival_target, a, seen))
    return false;
  copy_chunks<false>(window_of(own, a.window_bytes, a.w) + p * n16, a.out + p * n16, n16, b, G);
  publish(counter(a.base[p], a.window_bytes, a.w, 1, a.me),
          chunks_of_cta(b, G, (n16 + kChunk - 1) / kChunk));
  return true;
}

// Rank me's exchange. Every CTA takes chunks b, b + G, ... of every block,
// and goes through the TPU kernel's steps (pallas_halo.py:48-52): at step
// s = 1, ..., K-1 it stores into destination (me + s) mod K (so at each
// step the K ranks' sends form a permutation: each card sends to one peer
// and receives from one), after the destination's done counter says it
// has read exchange e - 2's, and publishes them; then it copies what step
// s - 1 brought, from source (me - s + 1) mod K, while step s's blocks are
// on the links (after step 1, its own block, which waits for nothing);
// last, the slot of step K - 1's source.
__global__ void __launch_bounds__(kThreads)
halo_rank_signalled_kernel(const __grid_constant__ RankArgs a) {
  __shared__ unsigned long long seen;
  if (threadIdx.x == 0) seen = 0;
  __syncthreads();
  const long long G = gridDim.x, b = blockIdx.x, n16 = a.n16;
  const long long chunks = (n16 + kChunk - 1) / kChunk;
  if (b >= chunks) return;
  const int K = a.K, me = a.me, w = a.w;
  char* own = a.base[me];
  for (int s = 1; s < K; ++s) {
    const int q = (me + s) % K;
    if (!wait_for(counter(own, a.window_bytes, w, 1, q), a.done_target, a, &seen)) return;
    copy_chunks(a.src + q * n16, window_of(a.base[q], a.window_bytes, w) + me * n16, n16, b, G);
    publish(counter(a.base[q], a.window_bytes, w, 0, me), chunks_of_cta(b, G, chunks));
    if (s == 1)
      copy_chunks(a.src + me * n16, a.out + me * n16, n16, b, G);
    else if (!copy_out_slot(a, (me - s + 1 + K) % K, &seen))
      return;
  }
  if (K == 1)
    copy_chunks(a.src, a.out, n16, b, G);
  else
    copy_out_slot(a, (me + 1) % K, &seen);
}

long long grid_x(long long n16, long long pairs) {
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  long long gx = (n16 + tile - 1) / tile;
  const long long cap = kMaxBlocks / pairs;
  if (gx > cap) gx = cap > 0 ? cap : 1;
  return gx;
}

// One launch over the (source p < P, destination q < K) block pairs of the
// shards in `t`: P = K, the stacked and list forms.
int launch(const Table& t, int P, int K, long long block_bytes, cudaStream_t stream) {
  const long long n16 = block_bytes / 16;
  const dim3 grid(static_cast<unsigned>(grid_x(n16, static_cast<long long>(P) * K)), P, K);
  halo_a2a_kernel<<<grid, kThreads, 0, stream>>>(t, n16);
  return cudaGetLastError();
}

// Resident CTAs of one wave of halo_pairs_kernel on the current device,
// read once a device.
constexpr int kMaxDevices = 64;
int g_wave[kMaxDevices];
int g_signalled_wave[kMaxDevices];

template <typename Kernel>
cudaError_t wave_of(Kernel kernel, int* cache, int* wave) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& w = cache[dev];
  if (w == 0) {
    int sms = 0, ctas = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    w = sms * (ctas > 0 ? ctas : 1);
  }
  *wave = w;
  return cudaSuccess;
}

cudaError_t pairs_wave(int* wave) { return wave_of(halo_pairs_kernel, g_wave, wave); }

// One launch of halo_pairs_kernel over n_pairs pairs of n16 pieces on the
// current device: a wave of CTAs over `share` (the launches that share the
// card), an equal part a pair.
int launch_pairs(const Pairs& t, int n_inter, int n_pairs, long long n16, int share,
                 cudaStream_t stream) {
  if (n_pairs < 1 || n_inter < 0 || n_inter > n_pairs || share < 1)
    return cudaErrorInvalidValue;
  if (n_inter == 0) n_inter = n_pairs;
  int wave = 0;
  const cudaError_t e = pairs_wave(&wave);
  if (e != cudaSuccess) return e;
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  const long long tiles = (n16 + tile - 1) / tile;
  long long per_pair = wave / share / n_pairs;
  if (per_pair > tiles) per_pair = tiles;
  if (per_pair < 1) per_pair = 1;
  const unsigned grid = static_cast<unsigned>(per_pair * n_pairs);
  halo_pairs_kernel<<<grid, kThreads, 0, stream>>>(t, n_inter, n_pairs, n16,
                                                   static_cast<int>(per_pair));
  return cudaGetLastError();
}

// The device form's plan: K sources, source p on device dev[p] with
// share[p] sources on its card, its destinations in order[p] (the remote
// ones first, its own last), and the events of an exchange, each made on
// its source's device: made[q] (destination q's stream reached the
// exchange), written[p] (source p's launch), t0[p] / t1[p] (around it,
// with timing, recorded where asked).
struct DevicePlan {
  int K;
  int dev[kMaxShards];
  int share[kMaxShards];
  int order[kMaxShards][kMaxShards];
  cudaEvent_t made[kMaxShards];
  cudaEvent_t written[kMaxShards];
  cudaEvent_t t0[kMaxShards];
  cudaEvent_t t1[kMaxShards];
};

void free_plan(DevicePlan* pl) {
  for (int p = 0; p < pl->K; ++p) {
    if (cudaSetDevice(pl->dev[p]) != cudaSuccess) continue;
    for (cudaEvent_t ev : {pl->made[p], pl->written[p], pl->t0[p], pl->t1[p]})
      if (ev) cudaEventDestroy(ev);
  }
  delete pl;
}

bool takes(int K, long long block_bytes) {
  return K >= 1 && K <= kMaxShards && block_bytes > 0 && block_bytes % 16 == 0;
}

bool aligned(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// cuStreamWaitValue64 / cuStreamWriteValue64, found once through the
// runtime (their CUDA 12.0 ABI), so no library here links libcuda.
typedef CUresult (*StreamValueFn)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);

struct StreamOps {
  StreamValueFn wait = nullptr;
  StreamValueFn write = nullptr;
  int error = 0;  // why they could not be found (0: found)
};

const StreamOps& stream_ops() {
  static const StreamOps ops = [] {
    StreamOps o;
    const char* names[2] = {"cuStreamWaitValue64", "cuStreamWriteValue64"};
    StreamValueFn* fns[2] = {&o.wait, &o.write};
    for (int i = 0; i < 2; ++i) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
      const cudaError_t e =
          cudaGetDriverEntryPointByVersion(names[i], &fn, 12000, cudaEnableDefault, &found);
#else
      const cudaError_t e = cudaGetDriverEntryPoint(names[i], &fn, cudaEnableDefault, &found);
#endif
      if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
        o.error = e != cudaSuccess ? e : cudaErrorSymbolNotFound;
        return o;
      }
      *fns[i] = reinterpret_cast<StreamValueFn>(fn);
    }
    return o;
  }();
  return ops;
}

// n stream operations of `fn` (a wait for >= value, or a write of value)
// on the words at `words`, each 8-byte aligned. Returns the first error.
int stream_values(StreamValueFn StreamOps::*which, unsigned flags, void* const* words, int n,
                  unsigned long long value, cudaStream_t stream) {
  const StreamOps& ops = stream_ops();
  if (ops.error) return ops.error;
  // A driver call needs a current context, which the runtime binds to a
  // thread only at its first call that needs one: a thread that so far
  // only launched kernels (PyTorch's autograd worker) may have none.
  // cudaSetDevice binds the device's primary context.
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(words[i]) % 8) return cudaErrorInvalidValue;
    const CUresult r = (ops.*which)(reinterpret_cast<CUstream>(stream),
                                    reinterpret_cast<CUdeviceptr>(words[i]), value, flags);
    if (r != CUDA_SUCCESS) return r;
  }
  return 0;
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
// of halo_pairs_kernel over the K pairs, the peers in the TPU kernel's
// order (me + 1, ..., me + K - 1) mod K round robin, its own block after
// them, a whole wave.
extern "C" int lp_halo_a2a_rank(const void* src, void* const* dst, int me, int K,
                                long long block_bytes, void* stream) {
  if (!takes(K, block_bytes) || me < 0 || me >= K) return cudaErrorInvalidValue;
  Pairs t = {};
  for (int j = 0; j < K; ++j) {
    const int q = (me + 1 + j) % K;  // j = K - 1: q = me, its own, last
    if (!aligned(src, dst[q])) return cudaErrorInvalidValue;
    t.src[j] = reinterpret_cast<const uint4*>(static_cast<const char*>(src) + q * block_bytes);
    t.dst[j] = reinterpret_cast<uint4*>(static_cast<char*>(dst[q]) + me * block_bytes);
  }
  return launch_pairs(t, K > 1 ? K - 1 : 1, K, block_bytes / 16, 1,
                      static_cast<cudaStream_t>(stream));
}

// One launch of the device form's kernel on the current device: n pairs,
// src[j] -> dst[j] of pair_bytes each, the first n_inter (0: all) round
// robin, the rest after; a wave of CTAs over `share`. The device form's
// exchange launches it once a source; alone it measures a set of pairs
// (a link, a source's links, every link).
extern "C" int lp_halo_pairs(const void* const* src, void* const* dst, int n_inter, int n,
                             long long pair_bytes, int share, void* stream) {
  if (!takes(n, pair_bytes)) return cudaErrorInvalidValue;
  Pairs t = {};
  for (int j = 0; j < n; ++j) {
    if (!aligned(src[j], dst[j])) return cudaErrorInvalidValue;
    t.src[j] = static_cast<const uint4*>(src[j]);
    t.dst[j] = static_cast<uint4*>(dst[j]);
  }
  return launch_pairs(t, n_inter, n, pair_bytes / 16, share,
                      static_cast<cudaStream_t>(stream));
}

// The device form's plan for K sources (see DevicePlan): dev, share (K
// each) and order (K x K, row p source p's destinations, its own last).
// Writes the plan's handle into *plan; a plan lives as long as the
// process. Returns the CUDA error (0 = made).
extern "C" int lp_halo_devices_plan(int K, const int* dev, const int* share, const int* order,
                                    void** plan) {
  *plan = nullptr;
  if (K < 1 || K > kMaxShards) return cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  DevicePlan* pl = new DevicePlan();
  pl->K = K;
  for (int p = 0; p < K && e == cudaSuccess; ++p) {
    pl->dev[p] = dev[p];
    pl->share[p] = share[p];
    for (int j = 0; j < K; ++j) pl->order[p][j] = order[p * K + j];
    if (share[p] < 1 || order[p * K + K - 1] != p) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) e = cudaSetDevice(dev[p]);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&pl->made[p], cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&pl->written[p], cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreate(&pl->t0[p]);
    if (e == cudaSuccess) e = cudaEventCreate(&pl->t1[p]);
  }
  if (e != cudaSuccess) {
    free_plan(pl);
    cudaSetDevice(prev);
    return e;
  }
  *plan = pl;
  return cudaSetDevice(prev);
}

// One exchange of the device form: src[p] source p's (K*Bh, F) buffer, dst[q]
// destination q's, streams[p] source p's stream (on dev[p]; streams may
// repeat), blocks of block_bytes. Block q of src[p] lands at block p of
// dst[q]. On each stream, in this order: every destination's stream records
// made[q]; each source's stream waits for the other streams' made events,
// launches (between t0[p] and t1[p] where `timed`) and records written[p];
// every destination's stream waits for the other streams' written events.
// The current device is restored. Returns the first CUDA error (0 = done).
extern "C" int lp_halo_devices_exchange(void* plan, const void* const* src, void* const* dst,
                                        void* const* streams, long long block_bytes, int timed) {
  DevicePlan* pl = static_cast<DevicePlan*>(plan);
  const int K = pl->K;
  if (!takes(K, block_bytes)) return cudaErrorInvalidValue;
  for (int p = 0; p < K; ++p)
    if (!aligned(src[p], dst[p])) return cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  auto st = [&](int p) { return static_cast<cudaStream_t>(streams[p]); };
  for (int q = 0; q < K && e == cudaSuccess; ++q) {
    e = cudaSetDevice(pl->dev[q]);
    if (e == cudaSuccess) e = cudaEventRecord(pl->made[q], st(q));
  }
  for (int p = 0; p < K && e == cudaSuccess; ++p) {
    e = cudaSetDevice(pl->dev[p]);
    for (int q = 0; q < K && e == cudaSuccess; ++q)
      if (st(q) != st(p)) e = cudaStreamWaitEvent(st(p), pl->made[q], 0);
    if (e != cudaSuccess) break;
    Pairs t = {};
    for (int j = 0; j < K; ++j) {
      const int q = pl->order[p][j];
      t.src[j] = reinterpret_cast<const uint4*>(static_cast<const char*>(src[p]) + q * block_bytes);
      t.dst[j] = reinterpret_cast<uint4*>(static_cast<char*>(dst[q]) + p * block_bytes);
    }
    if (timed) e = cudaEventRecord(pl->t0[p], st(p));
    if (e == cudaSuccess)
      e = static_cast<cudaError_t>(
          launch_pairs(t, K > 1 ? K - 1 : 1, K, block_bytes / 16, pl->share[p], st(p)));
    if (e == cudaSuccess && timed) e = cudaEventRecord(pl->t1[p], st(p));
    if (e == cudaSuccess) e = cudaEventRecord(pl->written[p], st(p));
  }
  for (int q = 0; q < K && e == cudaSuccess; ++q) {
    e = cudaSetDevice(pl->dev[q]);
    for (int p = 0; p < K && e == cudaSuccess; ++p)
      if (st(p) != st(q)) e = cudaStreamWaitEvent(st(q), pl->written[p], 0);
  }
  const cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}

// The device times of the last timed exchange on the plan, after waiting
// for it: ms[p] source p's launch (t0[p] to t1[p]) for p < K, then ms[K]
// the span from the first start to the last end, or -1 where the events
// lie on distinct devices (no common clock for cudaEventElapsedTime).
extern "C" int lp_halo_devices_times(void* plan, float* ms) {
  DevicePlan* pl = static_cast<DevicePlan*>(plan);
  const int K = pl->K;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  bool one_device = true;
  for (int p = 0; p < K && e == cudaSuccess; ++p) {
    one_device = one_device && pl->dev[p] == pl->dev[0];
    e = cudaSetDevice(pl->dev[p]);
    if (e == cudaSuccess) e = cudaEventSynchronize(pl->t1[p]);
    if (e == cudaSuccess) e = cudaEventElapsedTime(&ms[p], pl->t0[p], pl->t1[p]);
  }
  ms[K] = -1.f;
  if (e == cudaSuccess && one_device) {
    float lo = 0.f, hi = 0.f;
    for (int p = 0; p < K && e == cudaSuccess; ++p) {
      float a = 0.f, b = 0.f;
      e = cudaEventElapsedTime(&a, pl->t0[0], pl->t0[p]);
      if (e == cudaSuccess) e = cudaEventElapsedTime(&b, pl->t0[0], pl->t1[p]);
      lo = a < lo ? a : lo;
      hi = b > hi ? b : hi;
    }
    if (e == cudaSuccess) ms[K] = hi - lo;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}

// The rank form's copy-out: the first nbytes of this rank's own window
// (src) into dst, on the stream, after looking for an abort word among the
// K arrival words at `arrival` (recorded in *status, host-mapped memory as
// the device reaches it).
extern "C" int lp_halo_copy_out(const void* src, void* dst, long long nbytes, const void* arrival,
                                int K, void* status, void* stream) {
  if (!takes(K, nbytes) || !aligned(src, dst) || reinterpret_cast<uintptr_t>(arrival) % 8 ||
      status == nullptr)
    return cudaErrorInvalidValue;
  const long long n16 = nbytes / 16;
  halo_copy_out_kernel<<<static_cast<unsigned>(grid_x(n16, 1)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
      static_cast<const unsigned long long*>(arrival), K,
      static_cast<unsigned long long*>(status));
  return cudaGetLastError();
}

// One exchange of the signalled form for rank `me` of K over window w (0 or
// 1) of every rank's allocation: src this rank's (K*Bh, F) buffer, out its
// result, bases[p] rank p's allocation as this process reaches it (two
// windows of window_bytes, then the counters), blocks of block_bytes;
// aborts this rank's K abort words and status the word an abort seen is
// recorded in (both as the device reaches them, 8-byte aligned);
// arrival_target must be done_target plus this exchange's chunks. The grid
// is one wave of resident CTAs of the kernel over `share` (the streams that
// launch at once on the card), at most a block's chunks, at least one.
extern "C" int lp_halo_rank_signalled(const void* src, void* out, void* const* bases,
                                      long long window_bytes, int w, int me, int K,
                                      long long block_bytes, const void* aborts, void* status,
                                      unsigned long long arrival_target,
                                      unsigned long long done_target, int share, void* stream) {
  if (!takes(K, block_bytes) || me < 0 || me >= K || (w != 0 && w != 1) || share < 1 ||
      window_bytes < K * block_bytes || window_bytes % 16 || !aligned(src, out) ||
      reinterpret_cast<uintptr_t>(aborts) % 8 || reinterpret_cast<uintptr_t>(status) % 8 ||
      status == nullptr)
    return cudaErrorInvalidValue;
  const long long n16 = block_bytes / 16;
  const long long chunks = (n16 + kChunk - 1) / kChunk;
  if (arrival_target != done_target + static_cast<unsigned long long>(chunks))
    return cudaErrorInvalidValue;
  RankArgs a = {};
  for (int p = 0; p < K; ++p) {
    if (!aligned(bases[p], bases[p])) return cudaErrorInvalidValue;
    a.base[p] = static_cast<char*>(bases[p]);
  }
  a.src = static_cast<const uint4*>(src);
  a.out = static_cast<uint4*>(out);
  a.window_bytes = window_bytes;
  a.n16 = n16;
  a.aborts = static_cast<const unsigned long long*>(aborts);
  a.status = static_cast<unsigned long long*>(status);
  a.arrival_target = arrival_target;
  a.done_target = done_target;
  a.me = me;
  a.K = K;
  a.w = w;
  int wave = 0;
  const cudaError_t e = wave_of(halo_rank_signalled_kernel, g_signalled_wave, &wave);
  if (e != cudaSuccess) return e;
  long long grid = wave / share;
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;
  halo_rank_signalled_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Flag words. `words` holds n device addresses, 8-byte aligned, of words in
// the registered flag headers (lp_halo_flags_register). Each returns the
// CUDA error (runtime or driver; the codes agree for the common ones).

// The stream waits, before its later work, until each word is >= value.
extern "C" int lp_halo_flags_wait(void* const* words, int n, unsigned long long value,
                                  void* stream) {
  return stream_values(&StreamOps::wait, CU_STREAM_WAIT_VALUE_GEQ, words, n, value,
                       static_cast<cudaStream_t>(stream));
}

// The stream writes value into each word, after its earlier work and a
// memory barrier (its earlier stores land first).
extern "C" int lp_halo_flags_write(void* const* words, int n, unsigned long long value,
                                   void* stream) {
  return stream_values(&StreamOps::write, CU_STREAM_WRITE_VALUE_DEFAULT, words, n, value,
                       static_cast<cudaStream_t>(stream));
}

// A flag header: `bytes` of page-aligned host memory at `host` (this
// process's mapping of a rank's shared page) registered as mapped pinned
// memory, its device address in *dev. Portable: every context of the
// process reaches it.
extern "C" int lp_halo_flags_register(void* host, long long bytes, void** dev) {
  *dev = nullptr;
  cudaError_t e = cudaHostRegister(host, bytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (e != cudaSuccess) return e;
  e = cudaHostGetDevicePointer(dev, host, 0);
  if (e != cudaSuccess) {
    cudaHostUnregister(host);
    *dev = nullptr;
  }
  return e;
}

extern "C" int lp_halo_flags_unregister(void* host) { return cudaHostUnregister(host); }

// Receive windows for the rank form. Each returns the CUDA error (0 = done).
// A window pair is a whole cudaMalloc allocation, since an IPC handle names
// the base of one; handles are opaque bytes (lp_halo_ipc_handle_bytes of
// them).

extern "C" int lp_halo_ipc_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// Allocate `bytes` on the current device into *ptr, zeroed (the signalled
// form's counters start at 0) before the call returns, and write its
// handle.
extern "C" int lp_halo_window_alloc(long long bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return e;
  e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, *ptr);
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

// The status word: 8 zeroed bytes of pinned host memory mapped into the
// device, at *host for the host and *dev for the kernels.
extern "C" int lp_halo_status_alloc(void** host, void** dev) {
  *host = *dev = nullptr;
  cudaError_t e = cudaHostAlloc(host, sizeof(unsigned long long), cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  *static_cast<volatile unsigned long long*>(*host) = 0;
  e = cudaHostGetDevicePointer(dev, *host, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(*host);
    *host = *dev = nullptr;
  }
  return e;
}

extern "C" int lp_halo_status_free(void* host) { return cudaFreeHost(host); }

// Peer access for the device form: kernels on device `dev` may then store
// into memory of device `peer`. Returns 0 where it is on (this call or an
// earlier one: cudaErrorPeerAccessAlreadyEnabled, which PyTorch's own
// copies between cards leave behind, counts as success and is cleared from
// the thread's last error), -1 where cudaDeviceCanAccessPeer says the pair
// cannot, else the CUDA error. The current device is restored.
extern "C" int lp_halo_peer_enable(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return e;
  if (!can) return -1;
  int prev;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}
