// Sparse ruling-set list ranking (Helman-JaJa) for rings longer than the
// shared-memory kernels of list_rank.cu take (ops/list_rank.RANK_MAX_M):
// distance to the terminal of every token of a batch of successor rings.
//
// It replaces no Pallas kernel.  The JAX package ranks rings past
// PALLAS_RANK_MAX_M with plain XLA pointer doubling (fugue_batch.py's
// _wyllie_dist); so did the port (torch Wyllie, 20 rounds of two int64
// gathers over the whole ring).  The Euler ring of a 262,144-slot doc is
// 524,290 tokens: 2 MB as int32, far past one SM's shared memory, so the
// ring stays in device memory and the tables with it.
//
// Input.  succ int32 [n_docs, m]: an in-forest into self-loop terminals
// (any number of heads and of tokens sharing a successor, as the Euler
// ring of fugue_batch._ring_and_anchors, whose invalid tokens are chained
// by index into it).  A successor outside [0, m) is read as a terminal,
// so no pass reads outside the ring.
//
// Rulers.  A ruler is a token with i % K == 0 (the regular ruler of
// block i / K, slot i / K), a terminal, or a token whose in-degree is not
// 1: a head (0: nothing upstream would reach it) or a merge point (2 or
// more).  With merge points as rulers every other token has exactly one
// predecessor, so it lies on exactly one ruler's walk: no two walks write
// one token, and every walk ends (a cycle of non-rulers can be entered
// only through a token of in-degree 2).  A token u is linked when its
// predecessor is u - 1 (succ[u - 1] == u) and it is no ruler: then it
// has u - 1's owner and one step more.
//
// Passes (one stream, no host decision, no sync), the tables flat over
// the launch's docs (token i of doc d is d * m + i):
//   count  for every i whose successor is neither itself nor i + 1, two
//          bits of the successor (a predecessor other than i - 1, and a
//          second one) set by atomicOr: a 1/16-byte table that L2 holds;
//          the i + 1 predecessors are read back from succ by the mark.
//   mark   four tokens a thread: the ruler bit and the link bit of every
//          token, as (ruler, link) word pairs; the irregular rulers take
//          slots nblk, nblk + 1, ... by an atomic a ring.
//   walk   one thread a ruler follows succ to the next ruler, a run of
//          linked tokens at a time: the run's end is the first zero of
//          the link bits after the current token (runs stop at rulers, so
//          within K tokens), then one load of that end's successor, its
//          bit words and its own successor loaded together.  It writes
//          (owner slot, steps) as one u64 only at the tokens where a run
//          starts (its ruler and each successor that is not the next
//          index), and (steps, stop token) for its slot.
//   rank   one CTA a ring ranks its rulers: the stop token becomes the
//          stop's slot (the stop's own u64 holds it), then in-place
//          pointer jumping over (dist, next slot) u64 words, until no word
//          moves or ceil(log2 R) rounds have run, in shared memory when
//          the ring's R rulers fit the slots the launch reserved, else in
//          place in the walk's device-memory table (a star, where every
//          token is a head).  The CTA decides from the ring's own count;
//          in-place rounds are exact as in list_rank.cu (a word is read
//          and written whole, and a newer word only jumps further along
//          the same path).  dist of slot s lands in the dead rtok table.
//   expand four tokens a thread: the last unlinked token h <= i (at most
//          K back: rulers are unlinked) holds the run's owner word, and
//          dist[i] = D(owner) - (off[h] + i - h).
//
// What bounds it on an H100.  The walk is a chain of dependent loads.
// A first version, one load of succ and one store of the owner word a
// token, took 6.2 of its 8.7 ms in the walk on the import cell's rings
// (PERF.md): its lanes sit K tokens apart, so every step is 32 sectors in
// flight for 4 bytes each, and the owner stores are partial sectors.
// The element rings step to the next index 95 % of the time, so here a
// walk costs what it skips, not what it passes: a run of linked tokens is
// one bit scan, and only run starts are written.  What is left of the
// walk is its random sectors at the run starts (~5 % of the tokens: a
// successor read, an owner word written); the rest streams, four tokens a
// thread: succ read by count and mark (8 bytes a token), the bit tables
// (1/8 byte) and the expand's distance (4 bytes), ~12 bytes a token
// against the 8 that its input and output take (succ read once, dist
// written once).  A ring with no index runs (a random permutation) walks
// every token.  K (ops/list_rank.SPARSE_K) was chosen by a sweep on an
// H100 (PERF.md has the numbers).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // count, mark, walk, expand
constexpr int kRankThreads = 1024;  // ruler rank: one CTA a ring
// docs a launch: gridDim.y of the walk, and a multiple of 32 so that every
// launch's flat tables start at a whole bit word and a 16-byte boundary
constexpr int kMaxDocs = 65504;
constexpr uint64_t kHigh64 = 0xFFFFFFFF00000000ull;
constexpr uint32_t kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int ceil_log2(int x) {
  // max(1, ceil(log2(max(x, 2)))), as ops/list_rank.ceil_log2
  return x <= 2 ? 1 : 32 - __clz(x - 1);
}

// The four successors of flat tokens g0 .. g0 + 3 (g0 a multiple of 4;
// the ones past n are not read), in one 16-byte load when succ is 16-byte
// aligned (a view at an offset into a larger tensor may not be).
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ succ, size_t g0, size_t n, bool vec) {
  if (vec && g0 + 4 <= n) return *reinterpret_cast<const int4*>(succ + g0);
  int4 v = make_int4(0, 0, 0, 0);
  v.x = succ[g0];
  if (g0 + 1 < n) v.y = succ[g0 + 1];
  if (g0 + 2 < n) v.z = succ[g0 + 2];
  if (g0 + 3 < n) v.w = succ[g0 + 3];
  return v;
}

__device__ __forceinline__ uint32_t lane4(const int4& v, int k) {
  return (uint32_t)(k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w);
}

// Tables are flat over the launch's n = n_docs * m tokens: token i of doc
// d is g = d * m + i.  Four tokens a thread in count, mark and expand.
__global__ void __launch_bounds__(kThreads)
sparse_count(const int32_t* __restrict__ succ, uint32_t* __restrict__ deg, size_t n, int m, bool vec) {
  const size_t g0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (g0 >= n) return;
  const int4 v = load4(succ, g0, n, vec);
  size_t row = g0 / (size_t)m * m;
  uint32_t i = (uint32_t)(g0 - row);
#pragma unroll
  for (int k = 0; k < 4 && g0 + k < n; ++k) {
    const uint32_t s = lane4(v, k);
    if (s != i && s != i + 1 && s < (uint32_t)m) {
      // two bits a token: a predecessor other than i - 1, and a second one
      const size_t t = row + s;
      const uint32_t a = 1u << (2 * (t & 15));
      if (atomicOr(deg + (t >> 4), a) & a) atomicOr(deg + (t >> 4), a << 1);
    }
    if (++i == (uint32_t)m) i = 0, row += m;
  }
}

// A warp holds 128 tokens, 4 bit words; lane l's 4 bits sit at 4 (l % 8)
// of word l / 8, gathered by an OR across each 8-lane group.
__global__ void __launch_bounds__(kThreads)
sparse_mark(const int32_t* __restrict__ succ, const uint32_t* __restrict__ deg, uint2* __restrict__ bits,
            int32_t* __restrict__ rtok, uint32_t* __restrict__ nirr, size_t n, int m, int k_log2, bool vec) {
  const size_t g0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  const int lane = threadIdx.x & 31;
  const bool live = g0 < n;
  const int4 v = live ? load4(succ, g0, n, vec) : make_int4(0, 0, 0, 0);
  uint32_t prev = __shfl_up_sync(kAll, (uint32_t)v.w, 1);  // succ[g0 - 1]
  if (lane == 0) prev = live && g0 > 0 ? (uint32_t)succ[g0 - 1] : kAll;
  uint32_t rnib = 0, lnib = 0;
  if (live) {
    const uint32_t dw = deg[g0 >> 4] >> (2 * (g0 & 15));
    size_t row = g0 / (size_t)m * m;
    uint32_t i = (uint32_t)(g0 - row);
    const uint32_t kmask = (1u << k_log2) - 1u;
#pragma unroll
    for (int k = 0; k < 4 && g0 + k < n; ++k) {
      const uint32_t s = lane4(v, k);
      const bool from_prev = i > 0 && (k == 0 ? prev : lane4(v, k - 1)) == i;
      const uint32_t two = (dw >> (2 * k)) & 3u;  // bit 0: another predecessor; bit 1: two or more
      const bool one_pred = from_prev ? two == 0 : two == 1;
      const bool regular = (i & kmask) == 0;
      const bool ruler = regular || s == i || s >= (uint32_t)m || !one_pred;
      rnib |= (uint32_t)ruler << k;
      lnib |= (uint32_t)(from_prev && !ruler) << k;
      if (ruler && !regular) {  // an irregular ruler: a slot past the regular ones
        const size_t d = row / (size_t)m;
        rtok[row + atomicAdd(nirr + d, 1u)] = (int32_t)i;
      }
      if (++i == (uint32_t)m) i = 0, row += m;
    }
  }
  uint32_t rw = rnib << (4 * (lane & 7)), lw = lnib << (4 * (lane & 7));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    rw |= __shfl_xor_sync(kAll, rw, o);
    lw |= __shfl_xor_sync(kAll, lw, o);
  }
  if (live && (lane & 7) == 0) bits[g0 >> 5] = make_uint2(rw, lw);
}

// The last token of the run of linked tokens that follows flat token
// `pos` (p: the bit words of pos's word): the first unlinked token after
// pos, less one.  Token 0 of the next doc is a ruler and tokens past the
// launch's end are unlinked, so a run stays in its doc.
__device__ __forceinline__ size_t run_end(const uint2* __restrict__ bits, size_t pos, uint2 p, size_t words) {
  const size_t t = pos + 1;
  size_t w = t >> 5;
  const uint32_t link = w == (pos >> 5) ? p.y : (w < words ? bits[w].y : 0u);
  uint32_t open = ~link & (kAll << (t & 31));
  while (!open) {
    if (++w >= words) return (w << 5) - 1;
    open = ~bits[w].y;
  }
  return (w << 5) + (size_t)(__ffs(open) - 1) - 1;
}

__global__ void __launch_bounds__(kThreads)
sparse_walk(const int32_t* __restrict__ succ, const uint2* __restrict__ bits, const int32_t* __restrict__ rtok,
            const uint32_t* __restrict__ nirr, uint64_t* __restrict__ own, uint64_t* __restrict__ rw, int m,
            size_t words, int nblk, int k_log2) {
  const size_t row = (size_t)blockIdx.y * m;
  const int n_rulers = nblk + (int)nirr[blockIdx.y];
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < n_rulers; s += gridDim.x * kThreads) {
    const uint32_t t0 = s < nblk ? (uint32_t)s << k_log2 : (uint32_t)rtok[row + s - nblk];
    size_t pos = row + t0;
    own[pos] = (uint64_t)s;
    uint32_t nxt = (uint32_t)succ[pos], steps = 0;
    if (nxt == t0 || nxt >= (uint32_t)m) {
      nxt = t0;  // a terminal ruler: its own stop, weight 0
    } else {
      // every token but a terminal ruler has its successor in the ring
      uint2 p = bits[pos >> 5];
      while (true) {
        const size_t e = run_end(bits, pos, p, words);
        if (e != pos) nxt = (uint32_t)succ[e];
        steps += (uint32_t)(e - pos) + 1;
        const size_t g = row + nxt;
        p = bits[g >> 5];
        if ((p.x >> (g & 31)) & 1u) break;
        own[g] = ((uint64_t)steps << 32) | (uint32_t)s;  // a run start: nxt != e + 1
        pos = g;
        if (!((p.y >> ((g + 1) & 31)) & 1u) || ((g + 1) & 31) == 0) nxt = (uint32_t)succ[g];
      }
    }
    rw[row + s] = ((uint64_t)steps << 32) | nxt;
  }
}

// Inlined twice, with tbl in shared memory or in the walk's table.
__device__ __forceinline__ void rank_rulers(uint64_t* tbl, const uint64_t* __restrict__ own,
                                            int32_t* __restrict__ dtab, uint64_t* rw, int n_rulers) {
  for (int s = threadIdx.x; s < n_rulers; s += kRankThreads) {
    const uint64_t x = rw[s];
    tbl[s] = (x & kHigh64) | (uint32_t)own[(uint32_t)x];
  }
  __syncthreads();
  const int cap = ceil_log2(n_rulers);
  for (int r = 0; r < cap; ++r) {
    int moved = 0;
    for (int s = threadIdx.x; s < n_rulers; s += kRankThreads) {
      const uint64_t p = tbl[s];
      const uint32_t t = (uint32_t)p;
      const uint64_t q = tbl[t];
      if ((uint32_t)q == t) continue;  // target is a terminal: final
      tbl[s] = (p & kHigh64) + q;
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }
  for (int s = threadIdx.x; s < n_rulers; s += kRankThreads) dtab[s] = (int32_t)(tbl[s] >> 32);
}

__global__ void __launch_bounds__(kRankThreads)
sparse_rank_rulers(const uint64_t* __restrict__ own, uint64_t* rw, const uint32_t* __restrict__ nirr,
                   int32_t* __restrict__ dtab, int m, int nblk, int smem_slots) {
  extern __shared__ uint64_t ruler_tbl[];
  const size_t row = (size_t)blockIdx.x * m;
  const int n_rulers = nblk + (int)nirr[blockIdx.x];
  if (n_rulers <= smem_slots)
    rank_rulers(ruler_tbl, own + row, dtab + row, rw + row, n_rulers);
  else
    rank_rulers(rw + row, own + row, dtab + row, rw + row, n_rulers);
}

// The four tokens g0 .. g0 + 3 share one bit word; a token with no
// unlinked token at or below it there takes the last one before the word.
__global__ void __launch_bounds__(kThreads)
sparse_expand(const uint2* __restrict__ bits, const uint64_t* __restrict__ own, const int32_t* __restrict__ dtab,
              int32_t* __restrict__ dist, size_t n, int m) {
  const size_t g0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (g0 >= n) return;
  const size_t w = g0 >> 5;
  const uint32_t open = ~bits[w].y;
  size_t before = 0;
  if (!(open & (kAll >> (31 - (g0 & 31))))) {  // token 0 of a doc is a ruler: the scan stays in the doc
    size_t v = w;
    uint32_t o;
    do o = ~bits[--v].y; while (!o);
    before = (v << 5) + 31 - (size_t)__clz(o);
  }
  size_t row = g0 / (size_t)m * m;
  int out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t g = g0 + k;
    if (g >= n) break;
    const uint32_t at = open & (kAll >> (31 - (g & 31)));
    const size_t h = at ? (w << 5) + 31 - (size_t)__clz(at) : before;
    const uint64_t x = own[h];
    const uint32_t slot = (uint32_t)x < (uint32_t)m ? (uint32_t)x : 0u;  // in-forests write every run start
    if (g - row == (size_t)m) row += m;
    out[k] = dtab[row + slot] - (int32_t)((uint32_t)(x >> 32) + (uint32_t)(g - h));
  }
  if (g0 + 4 <= n) {
    *reinterpret_cast<int4*>(dist + g0) = make_int4(out[0], out[1], out[2], out[3]);
  } else {
    for (int k = 0; g0 + k < n; ++k) dist[g0 + k] = out[k];
  }
}

cudaError_t launch_docs(const int32_t* succ, int32_t* dist, uint32_t* deg, uint2* bits, int32_t* rtok,
                        uint32_t* nirr, uint64_t* own, uint64_t* rw, int n_docs, int m, int k_log2, int smem_slots,
                        cudaStream_t st) {
  const size_t n = (size_t)n_docs * m;
  const size_t words = (n + 31) / 32;
  const int nblk = ((m - 1) >> k_log2) + 1;
  const unsigned quad_blocks = (unsigned)((n + 4 * kThreads - 1) / (4 * kThreads));
  const unsigned walk_blocks = (unsigned)((nblk + kThreads - 1) / kThreads);
  cudaError_t e = cudaMemsetAsync(deg, 0, (n + 15) / 16 * sizeof(uint32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(nirr, 0, (size_t)n_docs * sizeof(uint32_t), st);
  if (e != cudaSuccess) return e;
  const bool vec = reinterpret_cast<uintptr_t>(succ) % 16 == 0;
  sparse_count<<<quad_blocks, kThreads, 0, st>>>(succ, deg, n, m, vec);
  sparse_mark<<<quad_blocks, kThreads, 0, st>>>(succ, deg, bits, rtok, nirr, n, m, k_log2, vec);
  sparse_walk<<<dim3(walk_blocks, n_docs), kThreads, 0, st>>>(succ, bits, rtok, nirr, own, rw, m, words, nblk,
                                                              k_log2);
  const int smem = smem_slots * (int)sizeof(uint64_t);
  e = cudaFuncSetAttribute(sparse_rank_rulers, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int32_t* dtab = rtok;  // rtok is dead after the walk
  sparse_rank_rulers<<<n_docs, kRankThreads, smem, st>>>(own, rw, nirr, dtab, m, nblk, smem_slots);
  sparse_expand<<<quad_blocks, kThreads, 0, st>>>(bits, own, dtab, dist, n, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// succ, dist: int32 [n_docs, m] contiguous on the current device (succ
// 4-byte aligned, read four at a time where it is 16-byte aligned; dist
// 16-byte aligned); scratch (contents ignored): deg uint32 [ceil(n_docs * m /
// 16)], bits uint32 [2 ceil(n_docs * m / 32)] (8-byte aligned), rtok
// int32 [n_docs, m], nirr uint32 [n_docs], own and rw uint64 [n_docs, m].
// k_log2: the ruler spacing's log2; smem_slots: the rulers one CTA ranks
// in shared memory (8 bytes each; cut to the device's opt-in limit).
// Returns the cudaError_t of the first failed call (0 = ok).
int sparse_rank_launch(const int32_t* succ, int32_t* dist, uint32_t* deg, uint32_t* bits, int32_t* rtok,
                       uint32_t* nirr, uint64_t* own, uint64_t* rw, int n_docs, int m, int k_log2, int smem_slots,
                       void* stream) {
  if (n_docs <= 0 || m <= 0) return (int)cudaSuccess;
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem_slots > optin / (int)sizeof(uint64_t)) smem_slots = optin / (int)sizeof(uint64_t);
  uint2* words = reinterpret_cast<uint2*>(bits);
  for (int d0 = 0; d0 < n_docs; d0 += kMaxDocs) {
    const int nd = n_docs - d0 < kMaxDocs ? n_docs - d0 : kMaxDocs;
    const size_t row = (size_t)d0 * m;
    e = launch_docs(succ + row, dist + row, deg + row / 16, words + row / 32, rtok + row, nirr + d0, own + row,
                    rw + row, nd, m, k_log2, smem_slots, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* sparse_rank_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
