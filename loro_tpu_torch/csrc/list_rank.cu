// Hopper list-ranking kernels: distance to the terminal of a successor
// ring, for a batch of rings.
//
// Replaces all four kernels of loro_tpu/ops/pallas_rank.py.  Two shapes:
//
// - one CTA per ring: list_rank_kernel<kShared> (blocked
//   _rank_kernel_blocked and the ruling route _rank_kernel_ruling +
//   _ruling_from_packed) and list_rank_wyllie_kernel (packed Wyllie
//   _rank_kernel);
// - one thread-block cluster per ring: list_rank_wide_cluster_kernel
//   (_rank_kernel_wide, C = 8 CTAs, the ring split across their shared
//   memories) and list_rank_wyllie_cluster_kernel (packed Wyllie on rings
//   past one CTA's shared memory, C = 2).
//
// Packed state, as in the TPU kernels: one u32 per token, dist in the
// high 16 bits and successor in the low 16, so one 32-bit gather moves a
// consistent (dist, target) pair and a round is
//     p' = (p & 0xFFFF0000) + p[p & 0xFFFF].
// Terminals are self-loops with dist 0; the wrapper pads every ring with
// such terminals (to 128*k tokens for ruling and blocked, 128 for wyllie
// and wide).
//
// Blocked: phase A composes a pointer only while its target lies in the
// token's own block of 2^block_log2 tokens, for at most n_steps_a
// rounds, then the ruling phases below rank the block-exit graph.  The
// TPU kernel needs a windowed rotate loop (_vmem_gather_near) to keep
// its gathers block-local; here an in-block gather is one load from the
// same table, so that loop is not ported.
//
// Ruling: rulers are tokens with index % k == 0.  Phase 1 doubles every
// pointer whose target is not a ruler and stops when no pointer moved
// (an early-exit vote) or after ceil(log2 m) rounds.  Phase 2 ranks the
// dense ruler ring (slot r <-> token r*k, slot mr an absorbing sink for
// rulers whose phase-1 stop is a non-ruler terminal).  Phase 3:
// dist = d1 + dense_dist[t1 / k] unless t1 is a non-ruler terminal.
//
// Why doubling and not sublist walks.  A work-efficient phase 1 in
// which each ruler walks its sublist to the next ruler, one hop at a
// time, then again to write the distances (two hops a token, where
// doubling gathers ~3 times a token on the flagship chain rings) was
// built, held bit-exact and measured slower on one SM: a hop of a walk
// costs some 40-70 instructions of control flow (the next start, the
// two passes, divergent lanes), a doubling round some 12 a token with
// no divergence, so the walks lost on every ring measured (PERF.md has
// the per-phase cycles).  The same held for blocked's phase A.
//
// In-place rounds.  The TPU kernels double synchronously (read the whole
// table, then write it).  Here a round updates the table in place, with
// no second buffer: each word is read and written as one access of its
// full width, so a thread always sees a consistent (dist, target) pair,
// old or new.  Reading a newer pair only makes a pointer jump further
// along the same path; a pointer never passes its first stop (a ruler, a
// terminal, or whatever the phase stops at), because its target is never
// past that stop.  So the same round cap still reaches the fixpoint, and
// the fixpoint is unique: every pointer at its first stop with the exact
// distance to it.  The output is therefore bit-identical to the
// synchronous version; chip_smoke.py checks this against the plain
// torch version on the card.  Phase A of the blocked algorithm is the
// same argument with "first stop" read as the first token on the path
// outside the pointer's own block, or an in-block terminal.
//
// Across the CTAs of the wide kernel's cluster the argument needs every
// load to see one whole word, old or new, also when the word lies in
// another CTA.  Each
// word is written only by its own CTA, with a relaxed cluster-scope
// store (st.relaxed.cluster), and every gather is a relaxed cluster-scope
// load (ld.relaxed.cluster, from shared::cta for a word of the own CTA,
// from shared::cluster for a remote one), so concurrent accesses are
// morally strong and never tear.  A cluster barrier (arrive.release /
// wait.acquire) separates rounds, and no CTA exits while its shared
// memory may still be read: the last remote read precedes a barrier that
// every CTA waits on.  The two-CTA Wyllie kernel reads the other half
// from its mirror in device memory with aligned 32-bit loads that bypass
// L1 (ld.global.cg), which likewise see one whole word, old or new; the
// same cluster barrier orders each CTA's mirror stores of a round before
// the other CTA's gathers of the next.
//
// What bounds them on an H100.  The device-memory traffic is tiny (succ
// and w read once, dist written once: 12 bytes per token), so the bound
// is the gathers: how many rounds, and where each gather lands.  A
// gather from the CTA's own shared memory is cheap; a random gather from
// another CTA's (DSMEM) is not: it goes out as one small request over
// the SM-to-SM network, and a CTA issuing thousands of them is limited
// by that network's request rate, not by latency.  A cluster barrier
// with release semantics costs several times a block barrier.  So a
// cluster only pays where most gathers can stay local.  chip_smoke.py
// times the wide kernel on rings of both kinds (PERF.md has the numbers).
//
// Wide (list_rank_wide_cluster_kernel) replaces _rank_kernel_wide +
// _vmem_gather2 (pallas_rank.py:154-200): rings of 65,537-131,072
// lane-padded tokens, or weighted rings whose distances may pass 16
// bits.  (dist, succ) no longer fit one u32, and two separate int32
// tables updated in place could pair a new dist with an old succ.  So
// each token is one u64 word, dist in the high 32 bits and succ in the
// low 32, and a step is
//     p' = (p & 0xFFFFFFFF00000000) + tbl[p & 0xFFFFFFFF]:
// one aligned 64-bit load and one store (a dist that wraps past 32 bits
// wraps exactly as the int32 sum of the TPU kernel does).  8 bytes a
// token is 525 KB-1 MB a ring, past one block's 227 KB; plain Wyllie
// from a global table on one CTA a ring (~64 L2 gathers a thread a
// round, on 8 of 132 SMs) was ~6x slower than what follows.  The
// kernel holds the ring in C = 8 CTAs' shared memories (token i in CTA
// i / S at slot i % S, S = mp / C; 8 S bytes a CTA, 65.7 KB at
// mp = 65,664) and ranks it in three phases, so that almost every
// gather of the element rings (whose consecutive ring steps sit at
// nearby indices) stays local:
//   A (local, block barriers only): point every token at its exit token
//     (the first token on its path whose successor leaves the slice) or
//     its in-slice terminal, with the exact distance.  Work-efficient
//     through a slice-local ruling set: A1 doubles every token until its
//     target is a ruler (index % 8), an exit or a terminal; A2 doubles
//     the S / 8 rulers alone until their targets are exits or
//     terminals; A3 moves every other token past its ruler.  Exit
//     tokens never move in A, so "target outside the slice" marks them.
//   B (across the cluster): each exit steps over a non-exit target (a
//     word A left final) so that it points at an exit or a terminal; the
//     K exits of the ring then form the exit ring.  When it fits the
//     shared memory left over (K <= kcap; the element rings have ~2,000
//     exits), every CTA copies all K exit words with coalesced DSMEM
//     reads and ranks them alone with block barriers, and takes its own
//     exits' results.  A CTA may copy words another CTA is already
//     ranking in place; such a word is a later jump along the same path,
//     so the fixpoint is the same.  When it does not fit (rings whose
//     pointers mostly leave their slice), the exits double in place
//     across the cluster, one cluster barrier and cluster-wide vote a
//     round.
//   C (local): a non-exit token adds its exit's final distance.
// Three cluster barriers on the exit-ring path, one more per round on
// the other.  The table is swizzled (slot j ^ ((j >> 4) & 7)) so that
// A2's stride-8 ruler accesses spread over the shared-memory banks.  C
// = 8 (WIDE_CLUSTER in ops/list_rank.py) because 16-CTA clusters fit
// only about one a GPC (8 rings run in two waves) and 4 CTAs hold twice
// the tokens each; chip_smoke.py's sweep times C = 4, 8 and 16.
//
// Packed Wyllie (list_rank_wyllie_kernel, _rank_kernel).  What bounds
// a round on one SM is the work per word visited, not bytes: on the
// flagship chain rings (34,944 padded tokens, 8 rings, NVIDIA H100 80GB
// HBM3, 700 W) a round of the strided loop of jump_to_terminals (the
// kernel before) reads, gathers and stores every word with some 12 SASS
// instructions, 13-14 rounds, 0.0415-0.0434 ms.  Batching 8 gathers
// before their stores, with a per-word live mask walked by bit tricks,
// cost more instructions than it hid (0.0705 ms); so did consecutive
// ownership with the same batches (0.0928), and lean loops with the own
// word read from shared memory still lost (0.0522-0.0534).  What lands
// (0.0377 ms against 0.0415 in one A/B call):
//   - each thread owns W = ceil(mp / 1024) | 1 consecutive words (W odd,
//     so the 32 lanes at the same word fall into 32 banks) and holds
//     them in registers while W < kRegWords (40; mp <= 39,936; 64
//     registers, no spill).  A round needs no load of the own word, only
//     the gather and, if the word moved, the store: 9 SASS instructions
//     a word;
//   - the words are visited from the last to the first, so a word whose
//     target is the next own word (43 % of the flagship pointers point 1
//     ahead, 16 % 2 ahead) reads it already moved this round: 12-13
//     rounds where the strided order takes 13-14;
//   - a thread's slots past its last word hold a sentinel, the terminal
//     word mp appended to the table, so no slot needs a bounds test (a
//     test per word cost 4 instructions); groups of 8 words of which none
//     moved in a round are final and skipped in later rounds.  Pointing
//     each final word at the sentinel as well, so that its gather is a
//     broadcast, measured 3 % more cycles and was dropped;
//   - q = p - (p & 0xFFFF) + tbl[p & 0xFFFF] is the same sum as the TPU
//     kernel's (p & 0xFFFF0000) + g; q == p exactly when the target is a
//     terminal, which is when a word is final.
// Rings with W >= kRegWords keep the strided loop.  Early exit and the
// ceil(log2 m) cap stay.  In-place rounds stay exact although final
// words are skipped: a skipped word points at a terminal, which never
// changes, so its value is already the fixpoint's.
//
// Packed Wyllie past one CTA's shared memory (58,112 < mp <= 65,536;
// list_rank_wyllie_cluster_kernel).  The kernel before read the table
// from device memory on one CTA (~64 L2 gathers a thread a round).  Here
// two CTAs of a cluster each hold half the ring in shared memory (token i
// in CTA i / S, S = mp / 2 <= 32,768 words, 128 KB), and a gather into
// the own half is a shared-memory load.  A gather into the other half
// reads `mirror`, a copy of the ring in device memory that each CTA
// writes with every word it stores, and not the other CTA's shared memory:
// random DSMEM gathers measured 1.7x slower than one CTA's L2 gathers
// on random rings (0.2723 against 0.1591 ms at 8 rings of 58,240).  Rounds
// end with the cluster-wide vote below; words are final as above.
//
// The ruling route stays on one CTA.  The same split of the packed ring
// (and of the dense ruler ring with it) over a cluster of 2, 4 or 8
// CTAs was slower than one CTA at every size on the flagship chain
// rings, which send 30-38 % of their pointers out of a slice: phase 1's
// gathers are then mostly remote, and one SM's own shared memory serves
// them faster (PERF.md has the sweep).
//
// The cluster-wide early-exit vote.  After a round, each CTA votes with
// __syncthreads_or; a CTA where a word moved stores the round's number
// (1, 2, ...) into the vote word of every CTA, then all pass the cluster
// barrier and read their own vote word.  Rounds are separated by
// barriers, so the word only grows: after round v's barrier it is >= v
// exactly when some CTA moved in round v, whatever a faster CTA writes
// in round v + 1.  Every CTA so takes the same decision, and no word is
// ever reset.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kLow = 0xFFFFu;
constexpr uint32_t kHigh = 0xFFFF0000u;
constexpr uint64_t kHigh64 = 0xFFFFFFFF00000000ull;
constexpr int kClusterBatch = 8;  // wide kernel: remote gathers in flight per thread
constexpr uint32_t kSliceK = 8;    // wide kernel: ruler spacing inside a slice
constexpr int kStamps = 8;         // timed packed kernel: clock64 stamps per CTA

// Stamps of the timed Wyllie kernels, per CTA (ops/list_rank.py's
// WYLLIE_STAMPS): clock64 at the start, after the load, after round r
// (kRoundAt + r), after the store; the words that moved in round r
// (kMovedAt + r) and the rounds taken.  n_steps <= kMaxRounds.
constexpr int kWyllieStamps = 40;
constexpr int kMaxRounds = 16;
constexpr int kRoundAt = 2;
constexpr int kMovedAt = kRoundAt + kMaxRounds;
constexpr int kStoreAt = kMovedAt + kMaxRounds;
constexpr int kRoundsAt = kStoreAt + 1;

template <bool kTimed>
__device__ __forceinline__ void wstamp(long long* stamps, int j) {
  if (kTimed && threadIdx.x == 0) stamps[(size_t)blockIdx.x * kWyllieStamps + j] = clock64();
}

// Round r's moved words, summed over the CTA (timed kernels only).
template <bool kTimed>
__device__ __forceinline__ void count_moved(long long* stamps, int r, int n) {
  if (!kTimed) return;
  n = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && n)
    atomicAdd(reinterpret_cast<unsigned long long*>(stamps + (size_t)blockIdx.x * kWyllieStamps + kMovedAt + r),
              (unsigned long long)n);
}

// Pointer jumping over tbl[0, len) until every pointer rests on a
// terminal (no pointer moved in a round) or `cap` rounds have run;
// returns the rounds run.  kTimed (the timed Wyllie kernel only) also
// stamps each round and counts the words it moved.
template <bool kTimed = false>
__device__ int jump_to_terminals(uint32_t* tbl, int len, int cap, long long* stamps = nullptr) {
  int r = 0;
  while (r < cap) {
    int moved = 0;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const uint32_t p = tbl[i];
      const uint32_t s = p & kLow;
      const uint32_t g = tbl[s];
      if ((g & kLow) == s) continue;  // target is a terminal: absorbed
      tbl[i] = (p & kHigh) + g;
      moved = kTimed ? moved + 1 : 1;
    }
    count_moved<kTimed>(stamps, r, moved);
    ++r;
    const int any = __syncthreads_or(moved);
    wstamp<kTimed>(stamps, kRoundAt + r - 1);
    if (!any) break;
  }
  return r;
}

// Stamps of the timed instantiation: thread 0 writes clock64() at the
// start and after each phase's closing barrier (ops/list_rank.py's
// PHASES names the phases between them).
template <bool kTimed>
__device__ __forceinline__ void stamp(long long* stamps, int j) {
  if (kTimed && threadIdx.x == 0) stamps[(size_t)blockIdx.x * kStamps + j] = clock64();
}

// The one-CTA packed kernel of the ruling phases: ruling, or blocked
// (ruling with n_steps_a > 0).  kTimed writes kStamps clock64 stamps a
// CTA to `stamps`; it runs the same code.
template <bool kShared, bool kTimed>
__global__ void __launch_bounds__(kThreads)
list_rank_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                 int32_t* __restrict__ dist, uint32_t* __restrict__ scratch, long long* stamps,
                 int mp, int n_steps, int n_steps_dense, int k_log2, int n_steps_a, int block_log2) {
  extern __shared__ uint32_t smem[];
  stamp<kTimed>(stamps, 0);
  const size_t row = (size_t)blockIdx.x * mp;
  const int mr = mp >> k_log2;
  const int words = mp + mr + 1;
  uint32_t* ring = kShared ? smem : scratch + (size_t)blockIdx.x * words;

  for (int i = threadIdx.x; i < mp; i += kThreads)
    ring[i] = ((uint32_t)w[row + i] << 16) | ((uint32_t)succ[row + i] & kLow);
  __syncthreads();
  stamp<kTimed>(stamps, 1);

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

  stamp<kTimed>(stamps, 2);
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

  stamp<kTimed>(stamps, 3);

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

  stamp<kTimed>(stamps, 4);

  // phase 3: recombine
  for (int i = threadIdx.x; i < mp; i += kThreads) {
    const uint32_t p = ring[i];
    const uint32_t t = p & kLow;
    uint32_t d = p >> 16;
    if ((t & kmask) == 0) d += dense[t >> k_log2] >> 16;
    dist[row + i] = (int32_t)d;
  }
  if (kTimed) {
    __syncthreads();
    stamp<kTimed>(stamps, 5);
  }
}

// ---- packed Wyllie ------------------------------------------------------

constexpr int kRegWords = 40;  // words a thread holds in registers (W <= 39: mp <= 39,936)

// Packed Wyllie on one CTA a ring, the table in shared memory.  With
// kRegs (W = ceil(mp / kThreads) | 1 < kRegWords) each thread holds its W
// consecutive words in registers and visits them from the last to the
// first, skipping groups of 8 of which none moved in a round.  Its slots
// past its last word hold the sentinel, the terminal tbl[mp] = mp, so no
// slot needs a bounds test.  Otherwise it runs the strided rounds of
// jump_to_terminals.  kTimed writes kWyllieStamps stamps a CTA to
// `stamps`.
template <bool kTimed, bool kRegs>
__global__ void __launch_bounds__(kThreads)
list_rank_wyllie_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                        int32_t* __restrict__ dist, long long* stamps, int mp, int n_steps) {
  extern __shared__ uint32_t tbl[];
  wstamp<kTimed>(stamps, 0);
  const size_t row = (size_t)blockIdx.x * mp;
  for (int i = threadIdx.x; i < mp; i += kThreads)
    tbl[i] = ((uint32_t)w[row + i] << 16) | ((uint32_t)succ[row + i] & kLow);
  if (kRegs && threadIdx.x == 0) tbl[mp] = (uint32_t)mp;  // the sentinel
  __syncthreads();

  int r = 0;
  if (kRegs) {
    const int W = (mp + kThreads - 1) / kThreads | 1;
    const uint32_t base = threadIdx.x * (uint32_t)W;
    const int n = max(0, min(W, mp - (int)base));  // own words base .. base + n - 1
    uint32_t word[kRegWords];
#pragma unroll
    for (int u = 0; u < kRegWords; ++u) word[u] = u < n ? tbl[base + u] : (uint32_t)mp;
    uint32_t live = (1u << kRegWords / 8) - 1;  // bit b: own words 8b .. 8b + 7 may still move
    wstamp<kTimed>(stamps, 1);
    while (r < n_steps) {
      int moved = 0;
#pragma unroll
      for (int b = kRegWords / 8 - 1; b >= 0; --b) {
        if (!((live >> b) & 1u)) continue;
        int group = 0;  // words of the group that moved (kTimed), or whether any did
#pragma unroll
        for (int v = 7; v >= 0; --v) {
          const int u = 8 * b + v;
          const uint32_t q = word[u] - (word[u] & kLow) + tbl[word[u] & kLow];
          if (q != word[u]) {  // else its target is a terminal: final
            word[u] = q;
            tbl[base + u] = q;
            group = kTimed ? group + 1 : 1;
          }
        }
        if (!group) live &= ~(1u << b);
        moved += group;
      }
      count_moved<kTimed>(stamps, r, moved);
      ++r;
      const int any = __syncthreads_or(moved);
      wstamp<kTimed>(stamps, kRoundAt + r - 1);
      if (!any) break;
    }
  } else {
    wstamp<kTimed>(stamps, 1);
    r = jump_to_terminals<kTimed>(tbl, mp, n_steps, stamps);
  }
  for (int i = threadIdx.x; i < mp; i += kThreads) dist[row + i] = (int32_t)(tbl[i] >> 16);
  if (kTimed) {
    __syncthreads();
    wstamp<kTimed>(stamps, kStoreAt);
    if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * kWyllieStamps + kRoundsAt] = r;
  }
}

// ---- the wide kernel: the ring in distributed shared memory -------------

// Relaxed cluster-scope accesses to shared memory.  `a` is a shared::cta
// address (this CTA's word) or, after mapa, a shared::cluster address.
template <typename W> __device__ __forceinline__ W ld_local(uint32_t a);
template <typename W> __device__ __forceinline__ W ld_remote(uint32_t a);
template <typename W> __device__ __forceinline__ void st_local(uint32_t a, W v);

template <> __device__ __forceinline__ uint32_t ld_local<uint32_t>(uint32_t a) {
  uint32_t v;
  asm volatile("ld.relaxed.cluster.shared::cta.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
template <> __device__ __forceinline__ uint64_t ld_local<uint64_t>(uint32_t a) {
  uint64_t v;
  asm volatile("ld.relaxed.cluster.shared::cta.b64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}
template <> __device__ __forceinline__ uint32_t ld_remote<uint32_t>(uint32_t a) {
  uint32_t v;
  asm volatile("ld.relaxed.cluster.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
template <> __device__ __forceinline__ uint64_t ld_remote<uint64_t>(uint32_t a) {
  uint64_t v;
  asm volatile("ld.relaxed.cluster.shared::cluster.b64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}
template <> __device__ __forceinline__ void st_local<uint32_t>(uint32_t a, uint32_t v) {
  asm volatile("st.relaxed.cluster.shared::cta.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
template <> __device__ __forceinline__ void st_local<uint64_t>(uint32_t a, uint64_t v) {
  asm volatile("st.relaxed.cluster.shared::cta.b64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ void st_remote32(uint32_t a, uint32_t v) {
  asm volatile("st.relaxed.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
// A word written before a cluster barrier and only read after it.
__device__ __forceinline__ uint16_t ld_remote16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared::cluster.u16 %0, [%1];" : "=h"(v) : "r"(a) : "memory");
  return v;
}

// The two halves of a cluster barrier (cluster.sync() is both).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The shared::cluster address of the same shared::cta address in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// x / d for x, d < 2^17 by one multiply: magic = ceil(2^40 / d) is exact
// there, because x * (magic * d - 2^40) < 2^17 * 2^17 < 2^40.
__device__ __forceinline__ uint64_t div_magic(uint32_t d) { return ((1ull << 40) + d - 1) / d; }
__device__ __forceinline__ uint32_t div_by(uint32_t x, uint64_t magic) {
  return (uint32_t)(((uint64_t)x * magic) >> 40);
}

// Where token s of a ring split in slices of `per` tokens lives: CTA q,
// local word off.
struct Split {
  uint32_t per;
  uint64_t magic;
  __device__ __forceinline__ void locate(uint32_t s, uint32_t& q, uint32_t& off) const {
    q = div_by(s, magic);
    off = s - q * per;
  }
};

// The cluster-wide early-exit vote of round number `vote` (see the note
// at the top): true when some CTA of the cluster moved a word.  Ends
// with the round's cluster barrier.
__device__ __forceinline__ bool cluster_any(cg::cluster_group& cluster, int moved, uint32_t vote_at,
                                            uint32_t vote) {
  if (__syncthreads_or(moved) && threadIdx.x < cluster.num_blocks())
    st_remote32(mapa(vote_at, threadIdx.x), vote);
  cluster.sync();
  return ld_local<uint32_t>(vote_at) >= vote;
}

// Wide ranking on one cluster of C CTAs per ring (grid = n_docs * C).
// Shared memory per CTA, with kcap >= 0 from the wrapper:
//   tbl u64[S] | exit ring u64[kcap + 1] | lid u16[S] | misc u32[64]
// misc[0] vote word, misc[1] this CTA's exit count, misc[2] K, misc[16 + q]
// the first exit-ring slot of CTA q's exits, misc[32..63] scan scratch.
// The table is swizzled (loc()) so that the rulers' stride-8 accesses
// of phase A2 do not all fall into two shared-memory banks.  Token j of
// this slice is thread (j % kThreads)'s token number j / kThreads in
// every phase, so a thread keeps its exit tokens as a bit mask.
__global__ void __launch_bounds__(kThreads)
list_rank_wide_cluster_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                              int32_t* __restrict__ dist, int mp, int n_steps, int kcap) {
  extern __shared__ uint64_t wide_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t n_cta = cluster.num_blocks();
  const uint32_t rank = cluster.block_rank();
  const uint32_t S = (uint32_t)mp / n_cta;
  const uint32_t first = rank * S;  // this slice is tokens [first, first + S)
  const size_t row = (size_t)(blockIdx.x / n_cta) * mp + first;
  uint64_t* const ring = wide_smem + S;
  uint16_t* const lid = reinterpret_cast<uint16_t*>(ring + kcap + 1);
  uint32_t* const misc = reinterpret_cast<uint32_t*>(lid + S);
  const uint32_t tbl_at = smem_addr(wide_smem), ring_at = smem_addr(ring), lid_at = smem_addr(lid);
  const uint32_t vote_at = smem_addr(misc);
  const Split split{S, div_magic(S)};
  // the word of local token j (the same address in every CTA of the cluster)
  auto loc = [&](uint32_t j) { return tbl_at + (j ^ ((j >> 4) & 7u)) * 8u; };
  auto mine = [&](uint32_t s) { return s - first < S; };

  for (uint32_t j = threadIdx.x; j < S; j += kThreads)
    st_local<uint64_t>(loc(j), ((uint64_t)(uint32_t)w[row + j] << 32) | (uint32_t)succ[row + j]);
  if (threadIdx.x == 0) misc[0] = 0;  // vote word
  __syncthreads();

  // phase A, local: point every token at its exit token (the first
  // token on its path whose successor leaves the slice) or its in-slice
  // terminal, with the exact distance, using only this CTA's words.
  // Exit tokens never move here, so "target outside the slice" tells
  // exits from the rest throughout; an in-slice path is at most S long.
  // A ruling set keeps it work-efficient: A1 doubles every token until
  // its target is a ruler (local index % kSliceK == 0), an exit or a
  // terminal; A2 doubles the S / kSliceK rulers alone until their targets
  // are exits or terminals; A3 moves every other token past its ruler.
  const int steps_a = S > 1 ? 32 - __clz(S - 1) : 1;
  uint32_t done = 0;  // bit u: token threadIdx.x + u * kThreads rests on its A1 stop
  for (int r = 0; r < steps_a; ++r) {  // A1
    int moved = 0;
    for (uint32_t u = 0, j = threadIdx.x; j < S; ++u, j += kThreads) {
      if ((done >> u) & 1u) continue;
      const uint64_t p = ld_local<uint64_t>(loc(j));
      const uint32_t s = (uint32_t)p;
      uint64_t g = 0;
      // an exit token, or a ruler, terminal or exit target: its stop for good
      if (!mine(s) || s % kSliceK == 0 || (uint32_t)(g = ld_local<uint64_t>(loc(s - first))) == s ||
          !mine((uint32_t)g)) {
        done |= 1u << u;
        continue;
      }
      st_local<uint64_t>(loc(j), (p & kHigh64) + g);
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }
  for (int r = 0; r < steps_a; ++r) {  // A2: rulers, at most S / kSliceK of them
    int moved = 0;
    for (uint32_t j = threadIdx.x * kSliceK; j < S; j += kThreads * kSliceK) {
      const uint64_t p = ld_local<uint64_t>(loc(j));
      const uint32_t s = (uint32_t)p;
      if (!mine(s)) continue;  // an exit token
      const uint64_t g = ld_local<uint64_t>(loc(s - first));
      const uint32_t t = (uint32_t)g;
      if (t == s || !mine(t)) continue;  // a terminal or exit target
      st_local<uint64_t>(loc(j), (p & kHigh64) + g);
      moved = 1;
    }
    if (!__syncthreads_or(moved)) break;
  }
  for (uint32_t j = threadIdx.x; j < S; j += kThreads) {  // A3: rulers' words are final now
    if (j % kSliceK == 0) continue;
    const uint64_t p = ld_local<uint64_t>(loc(j));
    const uint32_t s = (uint32_t)p;
    if (!mine(s) || s % kSliceK != 0) continue;  // an exit token, or not resting on a ruler
    const uint64_t g = ld_local<uint64_t>(loc(s - first));
    const uint32_t t = (uint32_t)g;
    if (t == s || !mine(t)) continue;  // the ruler is a terminal or an exit
    st_local<uint64_t>(loc(j), (p & kHigh64) + g);
  }
  __syncthreads();

  // number this CTA's exits 0 .. n - 1 (lid), by a block-wide scan of
  // the per-thread counts; misc[1] = n
  uint32_t exits = 0;  // bit u: token threadIdx.x + u * kThreads is an exit token
  for (uint32_t u = 0, j = threadIdx.x; j < S; ++u, j += kThreads)
    if (!mine((uint32_t)ld_local<uint64_t>(loc(j)))) exits |= 1u << u;
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const uint32_t own_n = __popc(exits);
  uint32_t incl = own_n;
  for (uint32_t o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) misc[32 + warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t x = misc[32 + lane];
    for (uint32_t o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += v;
    }
    misc[32 + lane] = x;
    if (lane == 31) misc[1] = x;
  }
  __syncthreads();
  uint32_t next = (warp ? misc[32 + warp - 1] : 0u) + incl - own_n;
  for (uint32_t u = 0, j = threadIdx.x; j < S; ++u, j += kThreads)
    if ((exits >> u) & 1u) lid[j] = (uint16_t)next++;
  cluster.sync();  // every slice's phase A, exit numbers and count done

  // exit-ring slots: CTA q's exits take [misc[16 + q], misc[16 + q + 1]) of [0, K)
  if (threadIdx.x < n_cta) misc[16 + threadIdx.x] = ld_remote<uint32_t>(mapa(vote_at + 4u, threadIdx.x));
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = 0;
    for (uint32_t q = 0; q < n_cta; ++q) {
      const uint32_t n = misc[16 + q];
      misc[16 + q] = acc;
      acc += n;
    }
    misc[2] = acc;
  }
  __syncthreads();
  const uint32_t K = misc[2];
  const bool in_ring = K <= (uint32_t)kcap;  // the same in every CTA
  const uint32_t own_first = misc[16 + rank];

  // phase B1: each exit token steps over a non-exit target (a word phase
  // A left final, pointing at that slice's exit token or terminal), so
  // that every exit points at an exit or a terminal, and (if the exit
  // ring fits) writes its exit-ring word: (distance, ring slot of that
  // exit, or K for a terminal).  Exit targets lie in other slices.
  for (uint32_t b = 0; b * kClusterBatch * kThreads < S; ++b) {
    const uint32_t bits = (exits >> (b * kClusterBatch)) & 0xFFu;
    if (!bits) continue;
    uint64_t p[kClusterBatch], g[kClusterBatch], g2[kClusterBatch];
    uint32_t q[kClusterBatch];
    uint16_t l2[kClusterBatch];
#pragma unroll
    for (int u = 0; u < kClusterBatch; ++u) {
      p[u] = g[u] = g2[u] = 0;
      q[u] = 0;
      l2[u] = 0;
      if ((bits >> u) & 1u) p[u] = ld_local<uint64_t>(loc(threadIdx.x + (b * kClusterBatch + u) * kThreads));
    }
#pragma unroll
    for (int u = 0; u < kClusterBatch; ++u) {
      if (!((bits >> u) & 1u)) continue;
      uint32_t off;
      split.locate((uint32_t)p[u], q[u], off);
      g[u] = ld_remote<uint64_t>(mapa(loc(off), q[u]));
    }
#pragma unroll
    for (int u = 0; u < kClusterBatch; ++u) {
      if (!((bits >> u) & 1u)) continue;
      const uint32_t y = (uint32_t)p[u], t = (uint32_t)g[u], qs = q[u] * S;
      if (t == y) continue;  // a terminal target
      if (t - qs < S) {      // a non-exit target: its stop t (an exit or a terminal)
        g2[u] = ld_remote<uint64_t>(mapa(loc(t - qs), q[u]));
        l2[u] = ld_remote16(mapa(lid_at + (t - qs) * 2u, q[u]));
      } else {  // an exit target
        l2[u] = ld_remote16(mapa(lid_at + (y - qs) * 2u, q[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kClusterBatch; ++u) {
      if (!((bits >> u) & 1u)) continue;
      const uint32_t j = threadIdx.x + (b * kClusterBatch + u) * kThreads;
      const uint32_t y = (uint32_t)p[u], t = (uint32_t)g[u], qs = q[u] * S;
      uint64_t e;
      if (t == y) {
        e = (p[u] & kHigh64) | K;
      } else if (t - qs >= S) {
        e = (p[u] & kHigh64) | (misc[16 + q[u]] + l2[u]);
      } else {
        const uint64_t np = (p[u] & kHigh64) + g[u];
        st_local<uint64_t>(loc(j), np);
        e = (np & kHigh64) | ((uint32_t)g2[u] == t ? K : misc[16 + q[u]] + l2[u]);
      }
      if (in_ring) st_local<uint64_t>(ring_at + (own_first + lid[j]) * 8u, e);
    }
  }
  cluster.sync();  // every exit-ring word and stepped exit word written

  if (in_ring) {
    // phase B2: copy the other slices' exit-ring words (coalesced DSMEM
    // reads) and rank the K + 1 words (slot K: a terminal) in this CTA
    // alone, with block barriers only.  Another CTA may already be
    // ranking its copy in place while this one copies from it: a word
    // read then is a later jump along the same path, as in the in-place
    // argument, so the fixpoint is the same.
    const uint32_t own_end = rank + 1 < n_cta ? misc[16 + rank + 1] : K;
    for (uint32_t i0 = threadIdx.x; i0 < K; i0 += kClusterBatch * kThreads) {
      uint64_t v[kClusterBatch];
#pragma unroll
      for (int u = 0; u < kClusterBatch; ++u) {
        const uint32_t i = i0 + u * kThreads;
        v[u] = 0;
        if (i >= K || (i >= own_first && i < own_end)) continue;
        uint32_t c = 0;  // the CTA whose exits own slot i
        while (c + 1 < n_cta && misc[16 + c + 1] <= i) ++c;
        v[u] = ld_remote<uint64_t>(mapa(ring_at + i * 8u, c));
      }
#pragma unroll
      for (int u = 0; u < kClusterBatch; ++u) {
        const uint32_t i = i0 + u * kThreads;
        if (i < K && (i < own_first || i >= own_end)) st_local<uint64_t>(ring_at + i * 8u, v[u]);
      }
    }
    if (threadIdx.x == 0) st_local<uint64_t>(ring_at + K * 8u, (uint64_t)K);
    cluster_arrive();  // this CTA's remote reads are done; cluster_wait() before exiting
    __syncthreads();
    for (int r = 0; r < n_steps; ++r) {
      int moved = 0;
      for (uint32_t i = threadIdx.x; i < K; i += kThreads) {
        const uint64_t e = ld_local<uint64_t>(ring_at + i * 8u);
        const uint32_t s = (uint32_t)e;
        const uint64_t g = ld_local<uint64_t>(ring_at + s * 8u);
        if ((uint32_t)g == s) continue;  // target is a terminal: absorbed
        st_local<uint64_t>(ring_at + i * 8u, (e & kHigh64) + g);
        moved = 1;
      }
      if (!__syncthreads_or(moved)) break;
    }
    for (uint32_t u = 0, j = threadIdx.x; j < S; ++u, j += kThreads)
      if ((exits >> u) & 1u) {
        const uint64_t p = ld_local<uint64_t>(loc(j));
        const uint64_t e = ld_local<uint64_t>(ring_at + (own_first + lid[j]) * 8u);
        st_local<uint64_t>(loc(j), (e & kHigh64) | (uint32_t)p);
      }
    __syncthreads();
  } else {
    // phase B2 when the exit ring does not fit (rings whose pointers
    // mostly leave their slice): Wyllie over the exit tokens in place,
    // across the cluster, one cluster barrier a round
    uint32_t vote = 0;
    for (int r = 0; r < n_steps; ++r) {
      int moved = 0;
      for (uint32_t b = 0; b * kClusterBatch * kThreads < S; ++b) {
        const uint32_t bits = exits >> (b * kClusterBatch);
        uint64_t p[kClusterBatch], g[kClusterBatch];
#pragma unroll
        for (int u = 0; u < kClusterBatch; ++u)
          p[u] = (bits >> u) & 1u ? ld_local<uint64_t>(loc(threadIdx.x + (b * kClusterBatch + u) * kThreads)) : 0;
#pragma unroll
        for (int u = 0; u < kClusterBatch; ++u) {
          g[u] = 0;
          if ((bits >> u) & 1u) {
            uint32_t q, off;
            split.locate((uint32_t)p[u], q, off);
            g[u] = q == rank ? ld_local<uint64_t>(loc(off)) : ld_remote<uint64_t>(mapa(loc(off), q));
          }
        }
#pragma unroll
        for (int u = 0; u < kClusterBatch; ++u) {
          // not an exit, or the target is a terminal (absorbed)
          if (!((bits >> u) & 1u) || (uint32_t)g[u] == (uint32_t)p[u]) continue;
          st_local<uint64_t>(loc(threadIdx.x + (b * kClusterBatch + u) * kThreads), (p[u] & kHigh64) + g[u]);
          moved = 1;
        }
      }
      if (!cluster_any(cluster, moved, vote_at, ++vote)) break;
    }
    // the last remote read preceded the last round's cluster barrier
  }

  // phase C, local: a non-exit token adds the final distance of the
  // exit token (or terminal, which adds 0) its phase-A pointer rests on
  for (uint32_t u = 0, j = threadIdx.x; j < S; ++u, j += kThreads) {
    const uint64_t p = ld_local<uint64_t>(loc(j));
    uint32_t d = (uint32_t)(p >> 32);
    if (!((exits >> u) & 1u)) {
      const uint32_t t = (uint32_t)p;
      const uint64_t g = ld_local<uint64_t>(loc(t - first));
      if ((uint32_t)g != t) d += (uint32_t)(g >> 32);
    }
    dist[row + j] = (int32_t)d;
  }
  if (in_ring) cluster_wait();
}

// ---- packed Wyllie on a cluster of two CTAs ------------------------------

constexpr uint32_t kWyllieCluster = 2;

// Packed Wyllie for a ring whose u32 table passes one CTA's shared memory
// (58,112 < mp <= 65,536): token i lives in CTA i / S at word i % S (S =
// mp / 2, at most 32,768 words = 128 KB a CTA), a gather into the own
// half is a shared-memory load.  One into the other half is a load from
// `mirror`, a copy of the ring in device memory (L2) that each CTA writes
// with every word it stores, not a DSMEM load (see the note at the top).
// Shared memory per CTA: tbl u32[S] | vote word u32 | pad.
template <bool kTimed>
__global__ void __launch_bounds__(kThreads)
list_rank_wyllie_cluster_kernel(const int32_t* __restrict__ succ, const int32_t* __restrict__ w,
                                int32_t* __restrict__ dist, uint32_t* mirror, long long* stamps, int mp,
                                int n_steps) {
  extern __shared__ uint32_t wyl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  wstamp<kTimed>(stamps, 0);
  const uint32_t rank = cluster.block_rank();
  const uint32_t S = (uint32_t)mp / kWyllieCluster;
  const uint32_t first = rank * S;
  const size_t ring0 = (size_t)(blockIdx.x / kWyllieCluster) * mp;
  const size_t row = ring0 + first;
  uint32_t* const ring_mirror = mirror + ring0;
  uint32_t* const tbl = wyl_smem;  // only this CTA reads it: the other CTA reads `mirror`
  const uint32_t vote_at = smem_addr(wyl_smem + S);
  for (uint32_t j = threadIdx.x; j < S; j += kThreads) {
    const uint32_t v = ((uint32_t)w[row + j] << 16) | ((uint32_t)succ[row + j] & kLow);
    tbl[j] = v;
    __stcg(ring_mirror + first + j, v);
  }
  if (threadIdx.x == 0) st_local<uint32_t>(vote_at, 0u);
  cluster.sync();  // both halves loaded before any gather

  const int n = ((int)S - (int)threadIdx.x + kThreads - 1) / kThreads;  // own words tid + u * kThreads
  uint64_t live = (1ull << n) - 1;  // bit u: own word u may still move (n <= 32)
  wstamp<kTimed>(stamps, 1);
  const int groups = (n + 7) >> 3;
  int r = 0;
  while (r < n_steps) {
    int moved = 0;
    for (int b = 0; b < groups; ++b) {
      const uint32_t bits = (uint32_t)(live >> (8 * b)) & 0xFFu;
      if (!bits) continue;
      uint32_t p[8], g[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) p[v] = (bits >> v) & 1u ? tbl[threadIdx.x + (8 * b + v) * kThreads] : 0u;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const uint32_t s = p[v] & kLow;
        g[v] = !((bits >> v) & 1u) ? 0u : s - first < S ? tbl[s - first] : __ldcg(ring_mirror + s);
      }
      uint32_t dead = 0;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (!((bits >> v) & 1u)) continue;
        const uint32_t j = threadIdx.x + (8 * b + v) * kThreads;
        const uint32_t q = p[v] - (p[v] & kLow) + g[v];
        if (q == p[v]) {  // the target is a terminal: final
          dead |= 1u << v;
          continue;
        }
        tbl[j] = q;
        __stcg(ring_mirror + first + j, q);
        ++moved;
      }
      live &= ~((uint64_t)dead << (8 * b));
    }
    count_moved<kTimed>(stamps, r, moved);
    ++r;
    const bool any = cluster_any(cluster, moved, vote_at, (uint32_t)r);
    wstamp<kTimed>(stamps, kRoundAt + r - 1);
    if (!any) break;
  }
  for (uint32_t j = threadIdx.x; j < S; j += kThreads) dist[row + j] = (int32_t)(tbl[j] >> 16);
  if (kTimed) {
    __syncthreads();
    wstamp<kTimed>(stamps, kStoreAt);
    if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * kWyllieStamps + kRoundsAt] = r;
  }
  // the other CTA's last vote store preceded the last round's cluster barrier
}

// Opts a cluster kernel into smem_bytes of dynamic shared memory a CTA
// (and, for clusters past 8, into non-portable cluster sizes) and fills
// *cfg for n_docs rings, one cluster of `cluster` CTAs each.
template <typename K>
cudaError_t cluster_config(K* kernel, int n_docs, int cluster, int smem_bytes, cudaStream_t st,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess && cluster > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(n_docs * cluster));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = (size_t)smem_bytes;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// Launches list_rank_wyllie_kernel (see list_rank_launch).
template <bool kTimed>
cudaError_t wyllie_launch(const int32_t* succ, const int32_t* w, int32_t* dist, long long* stamps, int n_docs,
                          int mp, int n_steps, cudaStream_t st) {
  const bool regs = ((mp + kThreads - 1) / kThreads | 1) < kRegWords;
  const int bytes = (mp + (regs ? 1 : 0)) * (int)sizeof(uint32_t);  // + the sentinel
  auto kernel = regs ? list_rank_wyllie_kernel<kTimed, true> : list_rank_wyllie_kernel<kTimed, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<n_docs, kThreads, bytes, st>>>(succ, w, dist, stamps, mp, n_steps);
  return cudaGetLastError();
}

// Launches list_rank_kernel<kShared, kTimed> (ruling plans) or the
// one-CTA Wyllie kernel (ruling = 0) (see list_rank_launch).
template <bool kTimed>
int packed_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* scratch, long long* stamps,
                  int n_docs, int mp, int n_steps, int n_steps_dense, int ruling, int k_log2, int n_steps_a,
                  int block_log2, int use_smem, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!ruling)  // packed Wyllie has no global-scratch variant: a longer ring takes the two-CTA kernel
    return (int)(use_smem ? wyllie_launch<kTimed>(succ, w, dist, stamps, n_docs, mp, n_steps, st)
                          : cudaErrorInvalidValue);
  const size_t words = (size_t)mp + (size_t)(mp >> k_log2) + 1;
  if (use_smem) {
    const size_t bytes = words * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(list_rank_kernel<true, kTimed>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    list_rank_kernel<true, kTimed><<<n_docs, kThreads, bytes, st>>>(
        succ, w, dist, nullptr, stamps, mp, n_steps, n_steps_dense, k_log2, n_steps_a, block_log2);
  } else {
    list_rank_kernel<false, kTimed><<<n_docs, kThreads, 0, st>>>(
        succ, w, dist, scratch, stamps, mp, n_steps, n_steps_dense, k_log2, n_steps_a, block_log2);
  }
  return (int)cudaGetLastError();
}

template <bool kTimed>
cudaError_t wyllie_cluster_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* mirror,
                                  long long* stamps, int n_docs, int mp, int n_steps, int smem_bytes, cudaStream_t st) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(list_rank_wyllie_cluster_kernel<kTimed>, n_docs, (int)kWyllieCluster, smem_bytes, st,
                                 &attr, &cfg);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, list_rank_wyllie_cluster_kernel<kTimed>, succ, w, dist, mirror, stamps, mp, n_steps);
  return e != cudaSuccess ? e : cudaGetLastError();
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
// ruling = 1 runs the ruling phases (scratch: uint32 [n_docs, mp + mp/k
// + 1] when use_smem is 0), n_steps_a > 0 the blocked phase A (blocks of
// 2^block_log2 tokens) before them; ruling = 0 runs packed Wyllie on one
// CTA a ring and needs use_smem = 1 (mp * 4 within one block's shared
// memory; a longer ring takes list_rank_wyllie_cluster_launch, and
// use_smem = 0 returns cudaErrorInvalidValue).  Returns the cudaError_t
// of the launch (0 = ok).
int list_rank_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* scratch,
                     int n_docs, int mp, int n_steps, int n_steps_dense, int ruling,
                     int k_log2, int n_steps_a, int block_log2, int use_smem, void* stream) {
  return packed_launch<false>(succ, w, dist, scratch, nullptr, n_docs, mp, n_steps, n_steps_dense, ruling, k_log2,
                              n_steps_a, block_log2, use_smem, stream);
}

// The same kernel, timed (ruling and blocked plans): stamps is int64
// [n_docs, 8], thread 0's clock64() at the start and after the load,
// phase A, phase 1, phase 2 and phase 3 (with the store); the last two
// are unused.
int list_rank_launch_timed(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* scratch,
                           long long* stamps, int n_docs, int mp, int n_steps, int n_steps_dense,
                           int k_log2, int n_steps_a, int block_log2, int use_smem, void* stream) {
  return packed_launch<true>(succ, w, dist, scratch, stamps, n_docs, mp, n_steps, n_steps_dense, 1, k_log2,
                             n_steps_a, block_log2, use_smem, stream);
}

// Packed Wyllie, timed: the one-CTA kernel (cluster = 1; needs use_smem =
// 1, as list_rank_launch) or the two-CTA cluster kernel (cluster = 2,
// scratch its mirror, smem_bytes a CTA).  stamps is int64 [n_docs * cluster,
// 40] of zeros, one row a CTA: clock64 at the start (0), after the load
// (1), after round r (2 + r), after the store (34); the words moved in
// round r (18 + r) and the rounds taken (35).
int list_rank_wyllie_launch_timed(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* scratch,
                                  long long* stamps, int n_docs, int mp, int n_steps, int use_smem, int cluster,
                                  int smem_bytes, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cluster == (int)kWyllieCluster)
    return (int)wyllie_cluster_launch<true>(succ, w, dist, scratch, stamps, n_docs, mp, n_steps, smem_bytes, st);
  return (int)(use_smem ? wyllie_launch<true>(succ, w, dist, stamps, n_docs, mp, n_steps, st) : cudaErrorInvalidValue);
}

// How many clusters of `cluster` CTAs, each CTA with `smem_bytes` of
// dynamic shared memory, the device can hold at once (*max_clusters; 0
// means such a cluster cannot be scheduled): of the wide kernel, or with
// wyllie = 1 of the two-CTA Wyllie kernel.  Returns the cudaError_t.
int list_rank_cluster_occupancy(int wyllie, int cluster, int smem_bytes, int* max_clusters) {
  *max_clusters = 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e;
  if (wyllie) {
    e = cluster_config(list_rank_wyllie_cluster_kernel<false>, 1, cluster, smem_bytes, nullptr, &attr, &cfg);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(max_clusters, (const void*)list_rank_wyllie_cluster_kernel<false>, &cfg);
  } else {
    e = cluster_config(list_rank_wide_cluster_kernel, 1, cluster, smem_bytes, nullptr, &attr, &cfg);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(max_clusters, (const void*)list_rank_wide_cluster_kernel, &cfg);
  }
  return (int)e;
}

// The wide kernel: one cluster of `cluster` CTAs per ring.  succ, w,
// dist: int32 [n_docs, mp] contiguous on the current device; mp is a
// multiple of cluster * 8; with S = mp / cluster, kcap >= 0 exit-ring
// slots and smem_bytes = 10 * S + 8 * (kcap + 1) + 256.  Returns the
// cudaError_t of the launch.
int list_rank_wide_launch(const int32_t* succ, const int32_t* w, int32_t* dist, int n_docs, int mp,
                          int n_steps, int kcap, int cluster, int smem_bytes, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(list_rank_wide_cluster_kernel, n_docs, cluster, smem_bytes, (cudaStream_t)stream,
                                 &attr, &cfg);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, list_rank_wide_cluster_kernel, succ, w, dist, mp, n_steps, kcap);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Packed Wyllie on a cluster of two CTAs a ring (58,112 < mp <= 65,536,
// mp even): succ, w, dist int32 [n_docs, mp] contiguous on the current
// device; mirror uint32 [n_docs, mp] scratch; smem_bytes = 4 * mp / 2 +
// 16.  Returns the cudaError_t.
int list_rank_wyllie_cluster_launch(const int32_t* succ, const int32_t* w, int32_t* dist, uint32_t* mirror,
                                    int n_docs, int mp, int n_steps, int smem_bytes, void* stream) {
  if (n_docs <= 0) return (int)cudaSuccess;
  return (int)wyllie_cluster_launch<false>(succ, w, dist, mirror, nullptr, n_docs, mp, n_steps, smem_bytes,
                                           (cudaStream_t)stream);
}

}  // extern "C"
