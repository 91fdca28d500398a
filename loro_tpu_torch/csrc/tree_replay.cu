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
// below the tree's depth (unsound, but deterministic).  The kernel runs
// the same walk as "stop at t": the loop ends where cur == t, and then
// cycle = cur == t (a hit, or a walk that ended on t), which is the
// same test.  An invalid row does not walk: its ok is false whatever a
// walk would find.
//
// What bounds it on an H100: latency, not bytes.  Each doc is one chain
// of dependent shared-memory loads (its moves plus its walk steps), a
// move's walk waiting on the table the previous move wrote; the bytes
// are 9 read and 1 written a move and 4 a node, microseconds at 3.35
// TB/s.  The least time is the longest doc's chain at one load latency
// a link (chip_smoke.py phase 4g prints it beside the kernel: 0.70 ms at
// [1,024, 2,048] on the tree traces, 28.74 cycles a load at 1,980 MHz).
//
// Design: one CTA is one warp, and it replays g docs (g = 1 .. 32, a
// power of two, a template argument, chosen by ops/tree_batch.
// plan_replay from the number of docs and the card's SMs: one doc a warp
// while the warps fit the card in one wave, more docs a warp past that).
// Lane j < g replays doc j.  Its exact table is its row of `parents`;
// beside it a walk table (n + 1 slots) in shared memory at an odd
// stride, so lanes at one index fall in distinct banks (below), or, past
// one CTA's shared memory (n past ~58,000), no walk table: the walk
// reads the exact table (the global variant).  No global load sits on
// the chain: the whole warp stages the moves in tiles (32 moves a doc,
// 16 where g = 32) in shared memory, every lane loading slots of every
// doc's contiguous row (coalesced), and loads each tile two tiles ahead
// into registers (in the permutation form the `order` words three tiles
// ahead, so the row gather has a tile to land).  The lanes meet once a
// tile, write the tile's effected bytes out (by row, so the sort's
// permutation needs no gather launch), and stage the next tile.
//  - One doc a warp (the main path at 1,024 docs, and the deep resident
//    cell): a tight walk a move.  A step is one load of the walk table
//    whose value is the next load's slot (load and address, as the chase
//    probe), issued two steps ahead so no exit test sits on the chain,
//    two steps an iteration; the next move is encoded a move ahead and
//    its first slot loaded ahead, forwarded when this move writes it.
//  - Docs sharing a warp: the walk is flattened; a lane whose move is
//    decided applies it and starts its next while the other lanes walk,
//    so a warp costs the longest of its docs' own chains over a tile,
//    not the sum over moves of the longest walk.
//  - The global variant's step is `table[min((unsigned)cur, n - 1)]`, the
//    clip as one unsigned min that also makes a finished walk's load safe.
//
// Measured on an H100 80GB HBM3 at 700 W (rank_ab.py's tree A/B,
// chip_smoke.py phase 4g): the PR 10 design (a thread a doc, 32 a warp)
// took 4.33 ms at [1,024, 2,048]: its warp walked 39.25 steps a move
// where a doc's mean is 19.21 (divergence) at ~137 cycles a step (the
// clip, the hit select and the exit test on the chain), the row loads
// 6 % of its cycles.  This design takes 1.35 ms there (the chain at ~52
// cycles a step and ~160 a move of bookkeeping).  What lost: the
// flattened loop at every g (2.16 ms at one doc a warp: 168 registers of
// runtime-sized staging, parameters reloaded from the constant bank in
// the walk); the walk with the clip on the chain (77.6 cycles a step);
// `volatile` walk-table accesses (4.57 ms, 177 cycles a step: volatile
// loads are strongly ordered); the compiler's own scheduling of
// the look-ahead loads (1.63 ms: it folded the load issued ahead back
// into the step).  More docs a warp at 1,024 docs: 1.99 ms at 2, 2.83 at
// 32; at 10,240 docs one doc a warp takes 6.85 ms (more warps than the
// card holds), 8 or 16 docs a warp 2.86-2.96 ms.
//
// The timed instantiation (kTimed, tree_replay_launch_timed) writes a
// warp's cycles in walk steps, in tile waits and in move bookkeeping,
// its step count and the active lanes of each step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kAbsent = -3;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpSlots = 512;  // moves a warp stages a tile, over its docs
constexpr int kTileCap = 32;     // moves a doc a tile
constexpr int kSlotBytes = 13;   // target, parent, row (int32), effected (byte)
constexpr int kStamps = 8;

__host__ __device__ constexpr int tile_moves(int g) { return g * kTileCap <= kWarpSlots ? kTileCap : kWarpSlots / g; }

__device__ __forceinline__ int32_t clip(int32_t x, int32_t n1) { return min(max(x, 0), n1); }

// clip for a walking cur (>= 0), and an index in the table for any other
// value, so a step's load may be issued before the walk's exit is known
__device__ __forceinline__ int32_t walk_index(int32_t x, int32_t n1) { return (int32_t)min((uint32_t)x, (uint32_t)n1); }

// A shared-memory word by its shared-window byte address.  asm volatile
// keeps these loads and stores in program order and where they stand
// (the compiler would otherwise fold a load issued ahead back into the
// step that uses it); to the card they are plain loads and stores.
__device__ __forceinline__ int32_t lds(uint32_t addr) {
  int32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts(uint32_t addr, int32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v));
}

// A value the compiler must keep in a register (it would otherwise load
// a kernel parameter from the constant bank again at every use in a loop)
__device__ __forceinline__ int32_t in_reg(int32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ int32_t* in_reg(int32_t* x) {
  asm volatile("" : "+l"(x));
  return x;
}

template <bool kTimed>
__device__ __forceinline__ long long stamp() {
  return kTimed ? clock64() : 0;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One warp replays kG docs, lane j < kG doc j.  The exact table (raw
// values) is the doc's row of `parents`.  kShared also keeps a walk
// table W in shared memory: W[i] is the shared-memory word index of the
// slot the raw value table[i] walks to: kStop (a word holding its own
// index) for a negative value, slot x for 0 <= x < n, slot n (a mirror
// of slot n - 1, as clip sends every value past n - 1 there) for x >= n.
// A walk step is then one load whose result is the next load's index,
// safe to issue before the exit test (kStop loops on itself), and a
// move of a target t in [0, n) is a cycle iff the walk meets slot t
// (slot n never equals it, kStop never does).  A target outside [0, n)
// walks the exact table in device memory (JAX's clip, exact compares).
//
// kTimed writes kStamps int64 a warp: cycles of the whole warp, of walk
// steps (the tile loops less the bookkeeping), of waits for staged moves
// (the prologue and each tile's refill), of move bookkeeping (deciding a
// move, the table writes, the effected byte, taking the next move), the
// warp's walk-step iterations, the active lanes summed over them, the
// lanes' walk steps, and over tiles the longest lane's walk steps.
template <bool kShared, bool kTimed, int kG>
__global__ void __launch_bounds__(kWarp)
tree_replay_kernel(const int32_t* __restrict__ target, const int32_t* __restrict__ parent,
                   const uint8_t* __restrict__ valid, const int32_t* __restrict__ order,
                   int32_t* __restrict__ parents, uint8_t* __restrict__ effected,
                   int n_docs, int m, int n, int d_max, int stride, long long* __restrict__ stamps) {
  constexpr int kTile = tile_moves(kG);
  constexpr int kSlots = kG * kTile;  // a tile's moves over the warp's docs
  constexpr int kK = kSlots / kWarp;  // slots a lane stages
  extern __shared__ int32_t smem[];
  const long long t_start = stamp<kTimed>();
  const int lane = threadIdx.x;
  const int doc0 = blockIdx.x * kG;
  const int ng = min(kG, n_docs - doc0);
  const int32_t n1 = in_reg(n - 1);
  const int stop = in_reg(kShared ? kG * stride : 0);  // kStop: the word after the walk tables
  int32_t* s_t = smem + (kShared ? stop + 1 : 0);
  int32_t* s_p = s_t + kSlots;
  int32_t* s_row = s_p + kSlots;
  uint8_t* s_e = reinterpret_cast<uint8_t*>(s_row + kSlots);

  for (int j = 0; j < ng; ++j) {
    int32_t* raw = parents + (size_t)(doc0 + j) * n;
    for (int i = lane; i < n; i += kWarp) raw[i] = kAbsent;
    if (kShared)
      for (int i = lane; i <= n; i += kWarp) smem[j * stride + i] = stop;
  }
  if (kShared && lane == 0) smem[stop] = stop;

  // slot i of this lane is s = lane + 32 i of the tile: doc s / kTile,
  // its move s % kTile of the tile.  ro: the row each slot stages
  // (order's word, or the move itself), -1 past the log; rr, rt, rp: a
  // tile's rows in flight, an invalid row as the move (0, 0), which the
  // cycle check rejects at once and which writes nothing.
  int32_t ro[kK], rr[kK], rt[kK], rp[kK];
  uint32_t rv[kK];
  auto load_order = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int s = lane + kWarp * i;
      const int j = s / kTile, k = k0 + s % kTile;
      const bool live = j < ng && k < m;
      ro[i] = !live ? -1 : order ? __ldg(order + (size_t)(doc0 + j) * m + k) : k;
    }
  };
  auto load_rows = [&]() {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int s = lane + kWarp * i;
      const size_t at = (size_t)(doc0 + s / kTile) * m + ro[i];
      const bool live = ro[i] >= 0;
      rr[i] = ro[i];
      rt[i] = live ? __ldg(target + at) : 0;
      rp[i] = live ? __ldg(parent + at) : 0;
      rv[i] = live ? __ldg(valid + at) : 0;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int s = lane + kWarp * i;
      s_t[s] = rv[i] ? rt[i] : 0;
      s_p[s] = rv[i] ? rp[i] : 0;
      s_row[s] = rr[i];
    }
  };
  auto flush = [&]() {  // the tile's effected bytes, at their rows
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int s = lane + kWarp * i;
      if (s_row[s] >= 0) effected[(size_t)(doc0 + s / kTile) * m + s_row[s]] = s_e[s];
    }
  };

  long long c_wait = 0, c_tiles = 0, c_book = 0, w_iters = 0, w_active = 0, l_steps = 0, m_steps = 0;
  const int n_tiles = (m + kTile - 1) / kTile;
  long long t0 = stamp<kTimed>();
  if (n_tiles > 0) {  // tile 0 staged; tile 1's rows and tile 2's order words in flight
    load_order(0);
    load_rows();
    stage();
    load_order(kTile);
    load_rows();
    load_order(2 * kTile);
  }
  __syncwarp();
  if (kTimed) c_wait += stamp<kTimed>() - t0;

  n = in_reg(n);
  d_max = in_reg(d_max);
  int32_t* raw = in_reg(parents + (size_t)(doc0 + lane) * n);  // this lane's exact table
  const int wb = in_reg(lane * stride);                         // its walk table's first slot (kShared)
  const int at = lane * kTile;                          // its doc's moves in a staged tile
  // the walk table's slot of a raw value
  auto enc = [&](int32_t x) -> int32_t { return x < 0 ? stop : wb + min(x, n); };
  // the walk table's slot of a target, -1 outside [0, n)
  auto slot_of = [&](int32_t x) -> int32_t { return (uint32_t)x < (uint32_t)n ? wb + x : -1; };
  // a move whose target is outside [0, n) walks the exact table (JAX's
  // clip, exact compares): whether it meets t
  auto exact = [&](int32_t t, int32_t p, int& steps) -> bool {
    int32_t cur = p;
    while (cur >= 0 && cur != t && steps < d_max) {
      cur = raw[clip(cur, n1)];
      ++steps;
    }
    return cur == t;
  };
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int kend = min(kTile, m - ti * kTile);
    t0 = stamp<kTimed>();
    int tile_steps = 0;
    if (kShared && kG == 1 && lane == 0) {
      // one doc a warp: a tight walk a move, each walk-table load issued
      // two steps ahead (lds).  The move being replayed (t, p, ta its
      // target's slot, e = enc(p) where its walk starts, tc its table
      // slot, hit whether its write lands on the next move's first slot),
      // the next one encoded ahead (t1, p1, ta1, e1, tc1, and nx1 = W[e1]
      // loaded ahead), the raw words of the one after (t2, p2)
      const uint32_t wsh = (uint32_t)__cvta_generic_to_shared(smem);
      auto W = [&](int32_t i) { return lds(wsh + 4u * (uint32_t)i); };
      int32_t t = s_t[0], p = s_p[0];
      int32_t t1 = 0, p1 = 0, t2 = 0, p2 = 0;
      if (kend > 1) {
        t1 = s_t[1];
        p1 = s_p[1];
      }
      if (kend > 2) {
        t2 = s_t[2];
        p2 = s_p[2];
      }
      int32_t ta = slot_of(t), e = enc(p), tc = clip(t, n1);
      int32_t ta1 = slot_of(t1), e1 = enc(p1), tc1 = clip(t1, n1);
      bool hit = e1 == wb + tc || (tc == n1 && e1 == wb + n);
      int32_t a = e, nx = W(e);
      int32_t nn = W(nx), nx1 = W(e1);
      for (int kk = 0;;) {
        int steps = 0;
        if (ta < 0) {
          a = exact(t, p, steps) ? ta : stop;
        } else {
          while (true) {  // two steps an iteration: one taken branch for two loads
            if (!((a != stop) & (a != ta) & (steps < d_max))) break;
            a = nx;
            nx = nn;
            nn = W(nn);
            ++steps;
            if (!((a != stop) & (a != ta) & (steps < d_max))) break;
            a = nx;
            nx = nn;
            nn = W(nn);
            ++steps;
          }
          if (kTimed) {
            w_iters += steps;
            w_active += steps;
          }
        }
        const long long tb = stamp<kTimed>();
        const bool ok = (a != ta) | (p < 0);
        if (ok) {
          sts(wsh + 4u * (uint32_t)(wb + tc), e);
          if (tc == n1) sts(wsh + 4u * (uint32_t)(wb + n), e);
        }
        const bool last = ++kk == kend;
        if (!last) {  // the next move's first two steps: its first slot was loaded ahead unless just written
          nx = ok & hit ? e : nx1;
          nn = W(nx);
        }
        if (ok) raw[tc] = p;
        s_e[kk - 1] = ok;
        if (kTimed) tile_steps += steps;
        if (last) {
          if (kTimed) c_book += stamp<kTimed>() - tb;
          break;
        }
        t = t1;
        p = p1;
        ta = ta1;
        e = e1;
        tc = tc1;
        a = e;
        t1 = t2;
        p1 = p2;
        ta1 = slot_of(t1);
        e1 = enc(p1);
        tc1 = clip(t1, n1);
        hit = e1 == wb + tc || (tc == n1 && e1 == wb + n);
        nx1 = W(e1);
        if (kk + 2 < kend) {
          t2 = s_t[kk + 2];
          p2 = s_p[kk + 2];
        }
        if (kTimed) c_book += stamp<kTimed>() - tb;
      }
    } else if (kShared && lane < ng) {
      // docs sharing a warp: one flattened loop, a lane whose move is
      // decided applies it and begins its next while the others walk
      int32_t t = s_t[at], p = s_p[at];
      int32_t t1 = 0, p1 = 0;
      if (kend > 1) {
        t1 = s_t[at + 1];
        p1 = s_p[at + 1];
      }
      int steps = 0, kk = 0;
      int32_t ta = 0, e = 0, a = 0, nx = 0;
      auto begin = [&]() {
        steps = 0;
        ta = slot_of(t);
        e = enc(p);
        a = e;
        if (ta < 0) {
          a = exact(t, p, steps) ? ta : stop;
          nx = stop;
        } else {
          nx = smem[a];
        }
      };
      begin();
      while (true) {
        const int32_t nn = smem[nx];  // the step after this one
        if ((a != stop) & (a != ta) & (steps < d_max)) {
          if (kTimed) {
            const unsigned am = __activemask();
            if (lane == __ffs(am) - 1) {
              ++w_iters;
              w_active += __popc(am);
            }
          }
          a = nx;
          nx = nn;
          ++steps;
          continue;
        }
        const long long tb = stamp<kTimed>();
        const bool ok = !(a == ta && p >= 0);
        if (ok) {
          const int32_t tc = clip(t, n1);
          smem[wb + tc] = e;
          if (tc == n1) smem[wb + n] = e;
          raw[tc] = p;
        }
        s_e[at + kk] = ok;
        if (kTimed) tile_steps += steps;
        const bool last = ++kk == kend;
        if (!last) {
          t = t1;
          p = p1;
          if (kk + 1 < kend) {
            t1 = s_t[at + kk + 1];
            p1 = s_p[at + kk + 1];
          }
          begin();
        }
        if (kTimed) {
          const unsigned am = __activemask();
          if (lane == __ffs(am) - 1) c_book += stamp<kTimed>() - tb;
        }
        if (last) break;
      }
    } else if (lane < ng) {  // the global variant: the walk reads the exact table
      int32_t t = s_t[at], p = s_p[at];
      int32_t t1 = 0, p1 = 0;
      if (kend > 1) {
        t1 = s_t[at + 1];
        p1 = s_p[at + 1];
      }
      int32_t cur = p, nx = raw[walk_index(p, n1)];
      int steps = 0, kk = 0;
      while (true) {
        const int32_t nn = raw[walk_index(nx, n1)];  // the step after this one, issued before its test
        if ((cur >= 0) & (cur != t) & (steps < d_max)) {
          if (kTimed) {
            const unsigned am = __activemask();
            if (lane == __ffs(am) - 1) {
              ++w_iters;
              w_active += __popc(am);
            }
          }
          cur = nx;
          nx = nn;
          ++steps;
          continue;
        }
        const long long tb = stamp<kTimed>();
        const bool ok = !(cur == t && p >= 0);
        if (ok) raw[clip(t, n1)] = p;
        s_e[at + kk] = ok;
        if (kTimed) tile_steps += steps;
        const bool last = ++kk == kend;
        if (!last) {
          t = t1;
          p = p1;
          if (kk + 1 < kend) {
            t1 = s_t[at + kk + 1];
            p1 = s_p[at + kk + 1];
          }
          cur = p;
          steps = 0;
          nx = raw[walk_index(cur, n1)];
        }
        if (kTimed) {
          const unsigned am = __activemask();
          if (lane == __ffs(am) - 1) c_book += stamp<kTimed>() - tb;
        }
        if (last) break;
      }
    }
    __syncwarp();
    if (kTimed) {
      c_tiles += stamp<kTimed>() - t0;
      l_steps += tile_steps;
      m_steps += __reduce_max_sync(kFull, tile_steps);
    }
    t0 = stamp<kTimed>();
    flush();
    __syncwarp();
    if (ti + 1 < n_tiles) {  // tile ti + 1 staged; its successors' loads issued
      stage();
      load_rows();
      load_order((ti + 3) * kTile);
    }
    __syncwarp();
    if (kTimed) c_wait += stamp<kTimed>() - t0;
  }
  if (kTimed) {
    const long long book = warp_sum(c_book), iters = warp_sum(w_iters), active = warp_sum(w_active);
    const long long steps = warp_sum(l_steps);
    if (lane == 0) {
      long long* out = stamps + (size_t)blockIdx.x * kStamps;
      out[0] = stamp<kTimed>() - t_start;
      out[1] = c_tiles - book;
      out[2] = c_wait;
      out[3] = book;
      out[4] = iters;
      out[5] = active;
      out[6] = steps;
      out[7] = m_steps;
    }
  }
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

template <bool kShared, bool kTimed, int kG>
int launch_g(const int32_t* target, const int32_t* parent, const uint8_t* valid, const int32_t* order,
             int32_t* parents, uint8_t* effected, long long* stamps, int n_docs, int m, int n, int d_max, int stride,
             void* stream) {
  const size_t smem = (kShared ? ((size_t)kG * stride + 1) * sizeof(int32_t) : 0) +
                      (size_t)kG * tile_moves(kG) * kSlotBytes;
  cudaError_t e = cudaFuncSetAttribute(tree_replay_kernel<kShared, kTimed, kG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n_docs + kG - 1) / kG;
  tree_replay_kernel<kShared, kTimed, kG><<<grid, kWarp, smem, (cudaStream_t)stream>>>(
      target, parent, valid, order, parents, effected, n_docs, m, n, d_max, stride, stamps);
  return (int)cudaGetLastError();
}

template <bool kShared, bool kTimed>
int launch(const int32_t* target, const int32_t* parent, const uint8_t* valid, const int32_t* order,
           int32_t* parents, uint8_t* effected, long long* stamps, int n_docs, int m, int n, int d_max, int g,
           int stride, void* stream) {
  if (n_docs <= 0) return 0;
  if (n < 1 || m < 0 || (kShared && stride <= n) || (kTimed && !stamps)) return (int)cudaErrorInvalidValue;
#define TREE_LAUNCH(G)                                                                                        \
  case G:                                                                                                     \
    return launch_g<kShared, kTimed, G>(target, parent, valid, order, parents, effected, stamps, n_docs, m, n, \
                                        d_max, stride, stream);
  switch (g) {
    TREE_LAUNCH(1)
    TREE_LAUNCH(2)
    TREE_LAUNCH(4)
    TREE_LAUNCH(8)
    TREE_LAUNCH(16)
    TREE_LAUNCH(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TREE_LAUNCH
}

}  // namespace

extern "C" {

// target, parent: int32 [n_docs, m]; valid: uint8 (bool) [n_docs, m];
// order: int32 [n_docs, m], a permutation of each doc's rows (the k-th
// move is row order[k]), or null for rows already in move order;
// parents: int32 [n_docs, n]; effected: uint8 [n_docs, m], both written
// in full.  All contiguous on the current device.  docs_per_warp: g, a
// power of two in 1..32 (one warp a CTA).  The exact tables are the
// rows of `parents`; use_smem = 1 also keeps each doc's walk table in
// shared memory ((g * stride + 1) * 4 bytes a CTA, stride > n, beside
// the move tile of g * tile * 13 bytes).  Returns the cudaError_t of
// the launch (0 = ok).
int tree_replay_launch(const int32_t* target, const int32_t* parent, const uint8_t* valid, const int32_t* order,
                       int32_t* parents, uint8_t* effected, int n_docs, int m, int n, int d_max, int use_smem,
                       int docs_per_warp, int stride, void* stream) {
  if (use_smem)
    return launch<true, false>(target, parent, valid, order, parents, effected, nullptr, n_docs, m, n, d_max,
                               docs_per_warp, stride, stream);
  return launch<false, false>(target, parent, valid, order, parents, effected, nullptr, n_docs, m, n, d_max,
                              docs_per_warp, n, stream);
}

// The timed instantiation of the same launch: stamps int64 [grid, 8]
// (grid = ceil(n_docs / docs_per_warp)), the fields of kTimed above.
int tree_replay_launch_timed(const int32_t* target, const int32_t* parent, const uint8_t* valid,
                             const int32_t* order, int32_t* parents, uint8_t* effected, long long* stamps,
                             int n_docs, int m, int n, int d_max, int use_smem, int docs_per_warp, int stride,
                             void* stream) {
  if (use_smem)
    return launch<true, true>(target, parent, valid, order, parents, effected, stamps, n_docs, m, n, d_max,
                              docs_per_warp, stride, stream);
  return launch<false, true>(target, parent, valid, order, parents, effected, stamps, n_docs, m, n, d_max,
                             docs_per_warp, n, stream);
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
