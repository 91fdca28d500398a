// Movable-tree replay: each document's move log, in global move-key
// order, applied to a parent table with the cycle check of Loro's
// diff_calc/tree.rs (a move whose new parent lies in the target's
// subtree at that moment is skipped).
//
// Replaces loro_tpu/ops/tree_batch.py:43 (tree_merge_doc, vmapped by
// tree_merge_batch and tree_replay_log_batch): an XLA lax.scan over the
// moves whose every step runs a lax.while_loop walk up the parent
// table.  It is not a Pallas kernel.  In eager torch the same replay is
// several launches a move and a device-to-host sync at every walk step
// (a `while` needs its condition on the host), hundreds of thousands of
// launches a call at 2,048 moves a doc; here it is one launch.
//
// What it computes, for each doc, bit for bit the JAX function (the
// results are integers): the table starts at ABSENT (-3); for the k-th
// move (t, p, v) of the doc's sorted log
//     cur = p; hit = false; steps = 0
//     while cur >= 0 && !hit && steps < d_max:
//         hit = cur == t
//         cur = hit ? ROOT - 10 : table[clip(cur, 0, n - 1)]
//         steps++
//     cycle = hit || cur == t
//     ok = v && !(cycle && p >= 0)
//     if ok: table[clip(t, 0, n - 1)] = p
//     effected[k] = ok
// with JAX's clip of out-of-range ordinals kept, so any input is taken
// without a bounds check on the host (no device-to-host sync: the
// wrapper can be captured in a CUDA graph), and any d_max, also one
// below the tree's depth (unsound, but deterministic).
//
// Design: one thread replays one doc, so a warp replays 32 docs and a
// CTA is that one warp (or fewer docs where their tables do not fit).
// Each doc's parent table lives in dynamic shared memory at a stride of
// n | 1 words (odd, so the 32 lanes at one index fall in 32 banks), and
// is written to `parents` at the end.  A table past one CTA's shared
// memory (n past ~58,000) is the doc's own row of `parents` in device
// memory (the global variant).  With `order` (the resident path) the
// k-th move is row order[k] of the unsorted log, and effected is written
// back at that row, so the sort's permutation needs no gather launch.
//
// What bounds it: latency, not bytes.  Each doc is one chain of
// dependent loads, a move's walk waiting on the table the previous move
// wrote; the bytes are 9 read and 1 written a move and 4 a node,
// microseconds at 3.35 TB/s.  The lanes of a warp walk in lockstep, so
// each move costs the longest walk among the warp's 32 docs, as the JAX
// vmap's batched while_loop costs the longest walk of the batch.  The
// next move's row is loaded before the walk, off that chain.  Left for
// later: a warp per doc, moves transposed to [M, D] for coalesced reads,
// docs sorted by log length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kRoot = -1;
constexpr int32_t kAbsent = -3;
constexpr int kMaxDocsPerCta = 32;

__device__ __forceinline__ int32_t clip(int32_t x, int32_t n) { return min(max(x, 0), n - 1); }

template <bool kShared>
__global__ void __launch_bounds__(kMaxDocsPerCta)
tree_replay_kernel(const int32_t* __restrict__ target, const int32_t* __restrict__ parent,
                   const uint8_t* __restrict__ valid, const int32_t* __restrict__ order,
                   int32_t* __restrict__ parents, uint8_t* __restrict__ effected,
                   int n_docs, int m, int n, int d_max, int stride) {
  extern __shared__ int32_t smem[];
  const int doc = blockIdx.x * blockDim.x + threadIdx.x;
  if (doc >= n_docs) return;  // no block barrier below: a lane may leave
  int32_t* out = parents + (size_t)doc * n;
  int32_t* table = kShared ? smem + (size_t)threadIdx.x * stride : out;
  for (int i = 0; i < n; ++i) table[i] = kAbsent;
  const size_t base = (size_t)doc * m;
  int row = 0, t = 0, p = kRoot;
  bool v = false;
  if (m > 0) {
    row = order ? order[base] : 0;
    t = target[base + row];
    p = parent[base + row];
    v = valid[base + row] != 0;
  }
  for (int k = 0; k < m; ++k) {
    // the next move's row, loaded before this move's walk
    int row_n = 0, t_n = 0, p_n = kRoot;
    bool v_n = false;
    if (k + 1 < m) {
      row_n = order ? order[base + k + 1] : k + 1;
      t_n = target[base + row_n];
      p_n = parent[base + row_n];
      v_n = valid[base + row_n] != 0;
    }
    int32_t cur = p;
    bool hit = false;
    for (int steps = 0; cur >= 0 && !hit && steps < d_max; ++steps) {
      hit = cur == t;
      cur = hit ? kRoot - 10 : table[clip(cur, n)];
    }
    const bool ok = v && !((hit || cur == t) && p >= 0);
    if (ok) table[clip(t, n)] = p;
    effected[base + row] = ok;
    row = row_n; t = t_n; p = p_n; v = v_n;
  }
  if (kShared)
    for (int i = 0; i < n; ++i) out[i] = table[i];
}

// A dependent chase through shared memory: one thread follows a ring of
// `len` words for `steps` loads and writes the SM cycles they took
// (clock64) and where it ended (so the loads are not dropped).
__global__ void smem_chase_kernel(int len, int steps, long long* cycles, int32_t* sink) {
  extern __shared__ int32_t ring[];
  for (int i = 0; i < len; ++i) ring[i] = (i + 97) % len;
  __syncthreads();
  int32_t cur = 0;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) cur = ring[cur];
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = cur;
}

template <bool kShared>
int launch(const int32_t* target, const int32_t* parent, const uint8_t* valid, const int32_t* order,
           int32_t* parents, uint8_t* effected, int n_docs, int m, int n, int d_max, int docs_per_cta,
           int stride, void* stream) {
  if (n_docs <= 0) return 0;
  if (n < 1 || m < 0 || docs_per_cta < 1 || docs_per_cta > kMaxDocsPerCta) return (int)cudaErrorInvalidValue;
  const size_t smem = kShared ? (size_t)docs_per_cta * stride * sizeof(int32_t) : 0;
  if (kShared) {
    cudaError_t e = cudaFuncSetAttribute(tree_replay_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n_docs + docs_per_cta - 1) / docs_per_cta;
  tree_replay_kernel<kShared><<<grid, docs_per_cta, smem, (cudaStream_t)stream>>>(
      target, parent, valid, order, parents, effected, n_docs, m, n, d_max, stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// target, parent: int32 [n_docs, m]; valid: uint8 (bool) [n_docs, m];
// order: int32 [n_docs, m], a permutation of each doc's rows (the k-th
// move is row order[k]), or null for rows already in move order;
// parents: int32 [n_docs, n]; effected: uint8 [n_docs, m], both written
// in full.  All contiguous on the current device.  use_smem = 1 keeps
// each doc's table in shared memory (docs_per_cta * stride * 4 bytes a
// CTA, stride >= n), 0 in its row of `parents`.  Returns the cudaError_t
// of the launch (0 = ok).
int tree_replay_launch(const int32_t* target, const int32_t* parent, const uint8_t* valid, const int32_t* order,
                       int32_t* parents, uint8_t* effected, int n_docs, int m, int n, int d_max, int use_smem,
                       int docs_per_cta, int stride, void* stream) {
  if (use_smem)
    return launch<true>(target, parent, valid, order, parents, effected, n_docs, m, n, d_max, docs_per_cta,
                        stride, stream);
  return launch<false>(target, parent, valid, order, parents, effected, n_docs, m, n, d_max, docs_per_cta, n,
                       stream);
}

// One thread's chase of `steps` dependent shared-memory loads on a ring
// of `len` words: cycles int64 [1], sink int32 [1].
int tree_smem_chase(int len, int steps, long long* cycles, int32_t* sink, void* stream) {
  if (len < 1 || len > 8192) return (int)cudaErrorInvalidValue;
  smem_chase_kernel<<<1, 1, len * sizeof(int32_t), (cudaStream_t)stream>>>(len, steps, cycles, sink);
  return (int)cudaGetLastError();
}

const char* tree_replay_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
