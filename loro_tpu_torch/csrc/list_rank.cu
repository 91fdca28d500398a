// Hopper list-ranking kernels: distance to the terminal of a successor
// ring, for a batch of rings (one CTA per ring).
//
// Replaces all four kernels of loro_tpu/ops/pallas_rank.py.
//
// list_rank_kernel<kShared> replaces _rank_kernel_ruling +
// _ruling_from_packed (the default "ruling" algorithm), _rank_kernel
// (packed Wyllie) and _rank_kernel_blocked (blocked phase A, then the
// ruling phases).  Same packed state as the TPU kernels: one u32 per
// token, dist in the high 16 bits and successor in the low 16, so one
// 32-bit gather moves a consistent (dist, target) pair and a round is
//     p' = (p & 0xFFFF0000) + p[p & 0xFFFF].
// Terminals are self-loops with dist 0; the wrapper pads every ring
// with such terminals (to 128*k tokens for ruling and blocked, 128 for
// wyllie).
//
// Blocked: phase A composes a pointer only while its target lies in
// the token's own block of 2^block_log2 tokens, for at most n_steps_a
// rounds, then the ruling phases below rank the block-exit graph.  The
// TPU kernel needs a windowed rotate loop (_vmem_gather_near) to keep
// its gathers block-local; here an in-block gather is one load from
// the same table, so that loop is not ported.
//
// Ruling: rulers are tokens with index % k == 0.  Phase 1 doubles every
// pointer whose target is not a ruler and stops when no pointer moved
// (block-wide __syncthreads_or vote) or after ceil(log2 m) rounds.
// Phase 2 ranks the dense ruler ring (slot r <-> token r*k, slot mr an
// absorbing sink for rulers whose phase-1 stop is a non-ruler terminal).
// Phase 3: dist = d1 + dense_dist[t1 / k] unless t1 is a non-ruler
// terminal.
//
// In-place rounds.  The TPU kernels double synchronously (read the whole
// table, then write it).  Here a round updates the table in place, with
// no second buffer: each word is read and written as one 32-bit access,
// so a thread always sees a consistent (dist, target) pair, old or new.
// Reading a newer pair only makes a pointer jump further along the same
// path; a pointer never passes its first stop (a ruler or a terminal),
// because its target is never past that stop.  So the same round cap
// still reaches the fixpoint, and the fixpoint is unique: every pointer
// at its first stop with the exact distance to it.  The output is
// therefore bit-identical to the synchronous version; chip_smoke.py
// checks this against the plain torch version on the card.  Phase A of
// the blocked algorithm is the same argument with "first stop" read as
// the first token on the path outside the pointer's own block, or an
// in-block terminal: a target s in the block rests somewhere between s
// and that same stop (s's block is the pointer's block), so composing
// with any version of s never passes it, and the fixpoint is unique.
//
// What bounds it on an H100: the device-memory traffic is tiny (succ and
// w read once, dist written once: 12 bytes per token), so the bound is
// the latency of dependent shared-memory gathers times the number of
// rounds.  The whole ring stays in shared memory for all rounds when it
// fits (a flagship ring of ~37.9k tokens is ~148 KB plus ~19 KB for the
// dense ruler ring); above the opt-in shared-memory limit the same code
// runs with its tables in a global scratch buffer the wrapper allocates
// (kShared = false), where the gathers hit L1/L2.  One CTA per ring
// means an 8-doc chunk occupies 8 of the 132 SMs; filling the card
// (a thread-block cluster sharing one ring, or more docs per launch) is
// left to a later change.
//
// list_rank_wide_kernel replaces _rank_kernel_wide + _vmem_gather2: rings
// of 65,537-131,072 lane-padded tokens, or weighted rings whose
// distances may pass 16 bits.  (dist, succ) no longer fit one u32, and
// two separate int32 tables updated in place could pair a new dist with
// an old succ.  So each token is one u64 word, dist in the high 32 bits
// and succ in the low 32, and a round is
//     p' = (p & 0xFFFFFFFF00000000) + tbl[p & 0xFFFFFFFF]:
// one aligned 64-bit load and one store, and the in-place argument above
// holds unchanged (a dist that wraps past 32 bits wraps exactly as the
// int32 sum of the TPU kernel does).  8 bytes a token is 525 KB-1 MB a
// ring, past the 227 KB shared-memory limit, so the table lives in a
// global scratch buffer the wrapper allocates; eight rings (<= 8 MB)
// stay in the 50 MB L2.  The scratch is written by the kernel, so it is
// read through the ordinary coherent path (no __ldg, no const).  Bound:
// L2 latency of dependent gathers, ceil(log2 m) rounds; each thread
// issues four independent gathers before it stores, to keep several in
// flight.  One CTA per ring; sharing a ring across a thread-block
// cluster's distributed shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kLow = 0xFFFFu;
constexpr uint32_t kHigh = 0xFFFF0000u;
constexpr uint64_t kHigh64 = 0xFFFFFFFF00000000ull;
constexpr int kWideBatch = 4;  // independent gathers in flight per thread

// Pointer jumping over tbl[0, len) until every pointer rests on a
// terminal (no pointer moved in a round) or `cap` rounds have run.
__device__ void jump_to_terminals(uint32_t* tbl, int len, int cap) {
  for (int r = 0; r < cap; ++r) {
    int moved = 0;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const uint32_t p = tbl[i];
      const uint32_t s = p & kLow;
      const uint32_t g = tbl[s];
      if ((g & kLow) == s) continue;  // target is a terminal: absorbed
      tbl[i] = (p & kHigh) + g;
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
list_rank_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                 int32_t* __restrict__ dist, uint32_t* __restrict__ scratch, int mp,
                 int n_steps, int n_steps_dense, int ruling, int k_log2, int n_steps_a,
                 int block_log2) {
  extern __shared__ uint32_t smem[];
  const size_t row = (size_t)blockIdx.x * mp;
  const int mr = ruling ? (mp >> k_log2) : 0;
  const int words = mp + (ruling ? mr + 1 : 0);
  uint32_t* ring = kShared ? smem : scratch + (size_t)blockIdx.x * words;

  for (int i = threadIdx.x; i < mp; i += kThreads)
    ring[i] = ((uint32_t)w[row + i] << 16) | ((uint32_t)succ[row + i] & kLow);
  __syncthreads();

  if (!ruling) {
    jump_to_terminals(ring, mp, n_steps);
    for (int i = threadIdx.x; i < mp; i += kThreads) dist[row + i] = (int32_t)(ring[i] >> 16);
    return;
  }

  // blocked phase A: double pointers while the target is in the block
  for (int r = 0; r < n_steps_a; ++r) {
    int moved = 0;
    for (int i = threadIdx.x; i < mp; i += kThreads) {
      const uint32_t p = ring[i];
      const uint32_t s = p & kLow;
      if ((s >> block_log2) != ((uint32_t)i >> block_log2)) continue;  // out of block: frozen
      const uint32_t g = ring[s];
      if ((g & kLow) == s) continue;  // target is a terminal: absorbed
      ring[i] = (p & kHigh) + g;
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }

  const uint32_t kmask = (1u << k_log2) - 1u;
  // phase 1: double pointers until each rests on a ruler or a terminal
  for (int r = 0; r < n_steps; ++r) {
    int moved = 0;
    for (int i = threadIdx.x; i < mp; i += kThreads) {
      const uint32_t p = ring[i];
      const uint32_t s = p & kLow;
      if ((s & kmask) == 0) continue;  // target is a ruler: frozen
      const uint32_t g = ring[s];
      if ((g & kLow) == s) continue;  // target is a terminal: absorbed
      ring[i] = (p & kHigh) + g;
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }

  // phase 2: dense ruler ring + sink slot mr
  uint32_t* dense = ring + mp;
  for (int r = threadIdx.x; r < mr; r += kThreads) {
    const uint32_t p = ring[r << k_log2];
    const uint32_t t = p & kLow;
    const uint32_t dt = (t & kmask) ? (uint32_t)mr : (t >> k_log2);
    dense[r] = (p & kHigh) | dt;
  }
  if (threadIdx.x == 0) dense[mr] = (uint32_t)mr;
  __syncthreads();
  jump_to_terminals(dense, mr + 1, n_steps_dense);

  // phase 3: recombine
  for (int i = threadIdx.x; i < mp; i += kThreads) {
    const uint32_t p = ring[i];
    const uint32_t t = p & kLow;
    uint32_t d = p >> 16;
    if ((t & kmask) == 0) d += dense[t >> k_log2] >> 16;
    dist[row + i] = (int32_t)d;
  }
}

__global__ void __launch_bounds__(kThreads)
list_rank_wide_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                      int32_t* __restrict__ dist, uint64_t* scratch, int mp, int n_steps) {
  const size_t row = (size_t)blockIdx.x * mp;
  uint64_t* tbl = scratch + row;
  for (int i = threadIdx.x; i < mp; i += kThreads)
    tbl[i] = ((uint64_t)(uint32_t)w[row + i] << 32) | (uint32_t)succ[row + i];
  __syncthreads();
  for (int r = 0; r < n_steps; ++r) {
    int moved = 0;
    for (int base = threadIdx.x; base < mp; base += kWideBatch * kThreads) {
      uint64_t p[kWideBatch], g[kWideBatch];
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) {
        const int i = base + u * kThreads;
        p[u] = i < mp ? tbl[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) {
        const int i = base + u * kThreads;
        g[u] = i < mp ? tbl[(uint32_t)p[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) {
        const int i = base + u * kThreads;
        // out of range, or the target is a terminal (absorbed)
        if (i >= mp || (uint32_t)g[u] == (uint32_t)p[u]) continue;
        tbl[i] = (p[u] & kHigh64) + g[u];
        moved = 1;
      }
    }
    if (!__syncthreads_or(moved)) break;
  }
  for (int i = threadIdx.x; i < mp; i += kThreads) dist[row + i] = (int32_t)(uint32_t)(tbl[i] >> 32);
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`.
int list_rank_smem_budget(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* list_rank_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// succ, w, dist: int32 [n_docs, mp] contiguous on the current device.
// scratch: uint32 [n_docs, mp + (ruling ? mp/k + 1 : 0)] when use_smem
// is 0, else unused.  n_steps_a > 0 runs the blocked phase A (blocks of
// 2^block_log2 tokens) before the ruling phases.  Returns the
// cudaError_t of the launch (0 = ok).
int list_rank_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* scratch,
                     int n_docs, int mp, int n_steps, int n_steps_dense, int ruling,
                     int k_log2, int n_steps_a, int block_log2, int use_smem, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  const int mr = ruling ? (mp >> k_log2) : 0;
  const size_t words = (size_t)mp + (ruling ? (size_t)mr + 1 : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (use_smem) {
    const size_t bytes = words * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(list_rank_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    list_rank_kernel<true><<<n_docs, kThreads, bytes, st>>>(
        succ, w, dist, nullptr, mp, n_steps, n_steps_dense, ruling, k_log2, n_steps_a, block_log2);
  } else {
    list_rank_kernel<false><<<n_docs, kThreads, 0, st>>>(
        succ, w, dist, scratch, mp, n_steps, n_steps_dense, ruling, k_log2, n_steps_a, block_log2);
  }
  return (int)cudaGetLastError();
}

// The wide kernel.  succ, w, dist: int32 [n_docs, mp] contiguous on the
// current device; scratch: uint64 [n_docs, mp].  Returns the cudaError_t
// of the launch (0 = ok).
int list_rank_wide_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint64_t* scratch,
                          int n_docs, int mp, int n_steps, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  list_rank_wide_kernel<<<n_docs, kThreads, 0, (cudaStream_t)stream>>>(succ, w, dist, scratch, mp,
                                                                     n_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
