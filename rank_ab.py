#!/usr/bin/env python3
"""Compares the list-rank kernels and the tree replay kernel of several
source trees on one NVIDIA GPU, in turns, in one process.

Each TREE is a checkout of this repository (for instance the parent
commit unpacked with `git archive` under build/).  Its
loro_tpu_torch/csrc/list_rank.cu is built with nvcc into
build/rank_ab/ and called through its C interface
(list_rank_launch); the rings, plans and plain versions come from this
tree's loro_tpu_torch.  Cases, each timed in the order the trees are
given (e.g. parent, change, change, parent), every result held
bit-exact against the plain version first:

- ruling, blocked and packed Wyllie on the flagship chain rings
  [8, 35,840] (the chain merge's main-path shape);
- ruling, blocked and Wyllie on the flagship rings cycled over one ring
  per SM;
- ruling and blocked on the adversarial ruler-gap ring (m = 65,536) and
  on a random ring just over the ruling table's shared-memory budget, 8
  rings each, both in the global-scratch table variant;
- Wyllie on rings past its own table's shared-memory budget, 8 rings
  each: a random ring of m = 58,113, the gap ring and a random ring of
  m = 65,536, each tree on its own route for them: the two-CTA cluster
  kernel where the tree has one (list_rank_wyllie_cluster_launch), else
  its global-scratch variant;
- the wide kernel (list_rank_wide_launch, its cluster of 8) on the
  element rings [8, 65,664] (the element merge's main-path shape);
- per-phase cycles (thread 0's clock64 after each phase's barrier) of
  ruling and blocked on the flagship rings: the tree's timed entry point
  (list_rank_launch_timed) where it has one, else a copy of its source
  with stamps written in after the phase barriers (the packed kernel as
  it stood before that entry point existed; `instrument` finds them);
  and Wyllie's rounds taken and cycles per round on the flagship rings,
  for a tree with list_rank_wyllie_launch_timed.

The tree replay kernel: each tree's loro_tpu_torch/csrc/tree_replay.cu
built into build/rank_ab/ and called through its C interface
(tree_replay_launch), at its own layout: a tree with the timed entry
point (tree_replay_launch_timed) at this tree's plan_replay, an older
tree (one thread a doc, one warp a CTA) at its own rule.  Cases, each
result held bit-exact against this tree's replay_plain first: the
tree_doc traces at [1,024, 2,048] (n = 512, bench_tree's shape),
bench_tree's random columns there, the traces tiled to BASELINE config
5's [10,240, 2,048] (each doc held against its trace's plain result),
and the deep cell's 8 traces of 16,384 moves on 2,048 nodes in the
permutation form (each log shuffled, the kernel given the order; held
against the plain version on each log's first 4,096 moves, and whole
against the first tree's result).  Then each tree's timed split on the
traces and the random columns: the timed entry point, or for an older
tree a copy of its source with counters written in (instrument_tree).

Times, two for each tree and case (chip_smoke.both_ms): CUDA events
over 20 back-to-back launches ("eager_ms", the yardstick of
chip_smoke.py's kernels line), and the same 20 launches captured in a
CUDA graph and replayed ("ms"), each the median of 20 samples after 3
warm-ups.  Prints one line per case and a final `rank_ab {...}` JSON
line, with the card's name and power limit.
Usage:
    python3 rank_ab.py TREE [TREE ...]
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

CHUNK = 8
HBM_BYTES_PER_S = 3.35e12
STAMPS = 8
# where the phases of the packed kernel without a timed entry point end
# (anchor, text put before it or after it)
_PARENT_STAMPS = (
    ("  uint32_t* ring = kShared ? smem : scratch + (size_t)blockIdx.x * words;\n", "after", 0),
    ("    ring[i] = ((uint32_t)w[row + i] << 16) | ((uint32_t)succ[row + i] & kLow);\n  __syncthreads();\n", "after", 1),
    ("  const uint32_t kmask = (1u << k_log2) - 1u;\n  // phase 1:", "before", 2),
    ("  // phase 2: dense ruler ring + sink slot mr\n", "before", 3),
    ("  // phase 3: recombine\n", "before", 4),
    ("    dist[row + i] = (int32_t)d;\n  }\n}\n", "after_loop", 5),
)


def instrument(src: str) -> str:
    """A list_rank.cu without list_rank_launch_timed, with clock64
    stamps after its packed kernel's phase barriers, read back with
    list_rank_read_stamps."""
    head = "#include <cuda_runtime.h>\n"
    assert src.count(head) == 1, "no cuda_runtime include"
    src = src.replace(head, head + "__device__ long long g_rank_stamps[4096 * 8];\n"
                      "#define RANK_STAMP(j) if (ruling && threadIdx.x == 0) "
                      "g_rank_stamps[blockIdx.x * 8 + (j)] = clock64();\n")
    for anchor, where, j in _PARENT_STAMPS:
        assert src.count(anchor) == 1, f"anchor for stamp {j} not found once"
        if where == "after":
            new = anchor + f"  RANK_STAMP({j});\n"
        elif where == "before":
            new = f"  RANK_STAMP({j});\n" + anchor
        else:  # after the loop, inside the kernel
            new = anchor[:-2] + f"  __syncthreads();\n  RANK_STAMP({j});\n}}\n"
        src = src.replace(anchor, new)
    return src + ('\nextern "C" int list_rank_read_stamps(long long* out, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_rank_stamps, (size_t)n * 8 * sizeof(long long));\n}\n")


# counters written into the PR 10 tree replay kernel (one thread a doc,
# no timed entry point), in the fields of the timed kernel: per CTA the
# lanes' longest total, walk, wait and bookkeeping cycles, then the
# warp's walk iterations, the active lanes summed over them, the lanes'
# walk steps and over moves the longest lane's walk
_TREE_HEAD = "#include <stdint.h>\n"
_TREE_START = "  if (doc >= n_docs) return;  // no block barrier below: a lane may leave\n"
_TREE_LOOP = """    int32_t cur = p;
    bool hit = false;
    for (int steps = 0; cur >= 0 && !hit && steps < d_max; ++steps) {
      hit = cur == t;
      cur = hit ? kRoot - 10 : table[clip(cur, n)];
    }
    const bool ok = v && !((hit || cur == t) && p >= 0);
    if (ok) table[clip(t, n)] = p;
    effected[base + row] = ok;
"""
_TREE_PREFETCH = "    // the next move's row, loaded before this move's walk\n"
_TREE_END = "    for (int i = 0; i < n; ++i) out[i] = table[i];\n}\n"


def instrument_tree(src: str) -> str:
    """A tree_replay.cu of one thread a doc (no tree_replay_launch_timed)
    with clock64 counters around each move's wait for its row (a
    volatile shared store of it), its walk and its bookkeeping, written
    to a device array at the kernel's end and read back (and zeroed)
    with tree_replay_read_stamps."""
    for anchor in (_TREE_HEAD, _TREE_START, _TREE_LOOP, _TREE_PREFETCH, _TREE_END):
        assert src.count(anchor) == 1, f"tree anchor not found once: {anchor[:60]!r}"
    src = src.replace(_TREE_HEAD, _TREE_HEAD + "__device__ unsigned long long g_tree_stamps[4096 * 8];\n")
    src = src.replace(_TREE_START, _TREE_START + (
        "  __shared__ volatile int32_t tree_sink[32];\n"
        "  const long long T_START = clock64();\n"
        "  long long c_walk = 0, c_wait = 0, c_book = 0, w_iters = 0, w_active = 0, l_steps = 0, m_steps = 0;\n"))
    src = src.replace(_TREE_PREFETCH, "    const long long s0 = clock64();\n" + _TREE_PREFETCH)
    src = src.replace(_TREE_LOOP, """    tree_sink[threadIdx.x] = t ^ p ^ row ^ (int)v;
    const long long s1 = clock64();
    int32_t cur = p;
    bool hit = false;
    int walked = 0;
    for (int steps = 0; cur >= 0 && !hit && steps < d_max; ++steps) {
      const unsigned a = __activemask();
      if ((int)threadIdx.x == __ffs(a) - 1) { ++w_iters; w_active += __popc(a); }
      hit = cur == t;
      cur = hit ? kRoot - 10 : table[clip(cur, n)];
      ++walked;
    }
    const long long s2 = clock64();
    const bool ok = v && !((hit || cur == t) && p >= 0);
    if (ok) table[clip(t, n)] = p;
    effected[base + row] = ok;
    const long long s3 = clock64();
    c_wait += s1 - s0; c_walk += s2 - s1; c_book += s3 - s2;
    l_steps += walked;
    m_steps += __reduce_max_sync(__activemask(), walked);
""")
    src = src.replace(_TREE_END, """    for (int i = 0; i < n; ++i) out[i] = table[i];
  unsigned long long* st = g_tree_stamps + (size_t)blockIdx.x * 8;
  atomicMax(st + 0, (unsigned long long)(clock64() - T_START));
  atomicMax(st + 1, (unsigned long long)c_walk);
  atomicMax(st + 2, (unsigned long long)c_wait);
  atomicMax(st + 3, (unsigned long long)c_book);
  atomicAdd(st + 4, (unsigned long long)w_iters);
  atomicAdd(st + 5, (unsigned long long)w_active);
  atomicAdd(st + 6, (unsigned long long)l_steps);
  atomicMax(st + 7, (unsigned long long)m_steps);
}
""")
    return src + ('\nextern "C" int tree_replay_read_stamps(long long* out, int n) {\n'
                  "  cudaError_t e = cudaMemcpyFromSymbol(out, g_tree_stamps, (size_t)n * 8 * sizeof(long long));\n"
                  "  if (e != cudaSuccess) return (int)e;\n"
                  "  void* at = nullptr;\n"
                  "  e = cudaGetSymbolAddress(&at, g_tree_stamps);\n"
                  "  return (int)(e != cudaSuccess ? e : cudaMemset(at, 0, (size_t)n * 8 * sizeof(long long)));\n"
                  "}\n")


def build_tree(tag: str, source: str) -> ctypes.CDLL:
    """A tree's tree_replay.cu (or an instrumented copy) built with this
    tree's nvcc flags and bound."""
    from loro_tpu_torch import _build

    out_dir = ROOT / "build" / "rank_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{tag}.cu"
    cu.write_text(source)
    so = out_dir / f"lib{tag}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_replay_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.tree_replay_launch.restype = i32
    if hasattr(lib, "tree_replay_launch_timed"):
        lib.tree_replay_launch_timed.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.tree_replay_launch_timed.restype = i32
    if hasattr(lib, "tree_replay_read_stamps"):
        lib.tree_replay_read_stamps.argtypes = [ptr, i32]
        lib.tree_replay_read_stamps.restype = i32
    return lib


def tree_ab_cases(torch, dev) -> dict:
    """label -> (target, parent, valid, order or None, n, plain check):
    the A/B's tree cases on the card (the class docstring's list); the
    check takes a tree's (parents, effected) and raises unless they equal
    this tree's replay_plain (a prefix for the deep case)."""
    import numpy as np

    import chip_smoke as cs
    from loro_tpu_torch import tracegen
    from loro_tpu_torch.ops import tree_batch as tb
    from loro_tpu_torch.parallel.fleet import Fleet

    cid = tracegen.TREE_CID
    docs = [tracegen.tree_doc(cs.SEED * 1000 + i, n_moves=cs.TREE_MOVES, n_nodes=cs.TREE_NODES)
            for i in range(cs.TREE_DISTINCT)]
    cols_h, n = Fleet(device=dev)._stack_tree_cols([tb.extract_tree_from_payload(tracegen.tree_payload(d), cid)
                                                    for d in docs])
    tile = torch.arange(cs.TREE_DOCS) % cs.TREE_DISTINCT
    traces = [torch.from_numpy(c)[tile].contiguous().to(dev) for c in cols_h]
    m = traces[0].shape[1]
    rng = np.random.default_rng(cs.SEED)
    rand = [torch.from_numpy(rng.integers(0, n, (cs.TREE_DOCS, m)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2, n, (cs.TREE_DOCS, m)).astype(np.int32)).to(dev),
            torch.ones((cs.TREE_DOCS, m), dtype=torch.bool, device=dev)]
    big = [c[torch.arange(cs.TREE_BIG_DOCS, device=dev) % cs.TREE_DISTINCT].contiguous() for c in traces]
    ddocs = [tracegen.tree_doc(cs.SEED * 1000 + 100 + i, n_moves=cs.TREE_DEEP_MOVES, n_nodes=cs.TREE_DEEP_NODES,
                               sync_every=cs.TREE_DEEP_SYNC) for i in range(cs.TREE_DEEP_DOCS)]
    dcols, dn = Fleet(device=dev)._stack_tree_cols([tb.extract_tree_from_payload(tracegen.tree_payload(d), cid)
                                                    for d in ddocs])
    dn = max(dn, cs.TREE_DEEP_NODES)
    order = np.stack([rng.permutation(dcols.target.shape[1]) for _ in range(cs.TREE_DEEP_DOCS)]).astype(np.int32)
    rows = np.arange(cs.TREE_DEEP_DOCS)[:, None]
    shuffled = []
    for c in dcols:  # row order[k] holds the k-th move
        u = np.empty_like(c)
        u[rows, order] = c
        shuffled.append(torch.from_numpy(u).to(dev))
    dorder = torch.from_numpy(order).to(dev)
    pre = cs.TREE_DEEP_PLAIN_ROWS  # the deep logs' first moves, shuffled alone, held against the plain version
    porder = np.stack([rng.permutation(pre) for _ in range(cs.TREE_DEEP_DOCS)]).astype(np.int32)
    pshuffled = []
    for c in dcols:
        u = np.empty((cs.TREE_DEEP_DOCS, pre), c.dtype)
        u[rows, porder] = c[:, :pre]
        pshuffled.append(torch.from_numpy(u).to(dev))
    porder_t = torch.from_numpy(porder).to(dev)
    tile_dev = torch.arange(cs.TREE_BIG_DOCS, device=dev) % cs.TREE_DISTINCT
    want = tb.replay_plain(*traces, n)
    want_rand = tb.replay_plain(*rand, n)
    return [
        {"label": f"traces [{cs.TREE_DOCS}, {m}] n = {n}", "cols": traces, "order": None, "n": n, "want": want[:2],
         "loads": int(want[2].max()), "split": True},
        {"label": f"random [{cs.TREE_DOCS}, {m}] n = {n}", "cols": rand, "order": None, "n": n,
         "want": want_rand[:2], "loads": int(want_rand[2].max()), "split": True},
        {"label": f"traces tiled [{cs.TREE_BIG_DOCS}, {m}] n = {n}", "cols": big, "order": None, "n": n,
         "want": [x[tile_dev] for x in want[:2]], "loads": int(want[2].max()), "split": False},
        {"label": f"deep first {pre} moves, permutation form [{cs.TREE_DEEP_DOCS}, {pre}] n = {dn}", "cols": pshuffled,
         "order": porder_t, "n": dn, "want": tb.replay_plain(*pshuffled, dn, order=porder_t)[:2], "split": False,
         "untimed": True},
        {"label": f"deep permutation form [{cs.TREE_DEEP_DOCS}, {dcols.target.shape[1]}] n = {dn}", "cols": shuffled,
         "order": dorder, "n": dn, "want": None, "split": False},
    ]


def tree_parent_docs_per_cta(n: int) -> tuple:
    """(use_smem, docs a CTA, stride) of the PR 10 kernel: as many docs
    (one a thread, up to 32) as have their n | 1 word tables fit
    232,448 bytes, else the global variant at 32."""
    per = min(32, 232_448 // (4 * (n | 1)))
    return (1, per, n | 1) if per >= 1 else (0, 32, n)


def tree_ab(torch, dev, trees, card: str, cases=None) -> dict:
    """The tree replay A/B (the module docstring's tree cases, or
    `cases` from tree_ab_cases) over `trees` in the order given; returns
    {case: {...}} and prints one line a case and one a timed split."""
    import numpy as np

    import chip_smoke as cs
    from loro_tpu_torch.ops import tree_batch as tb

    t0 = time.perf_counter()
    libs = {}
    for i, tree in enumerate(dict.fromkeys(trees)):
        src = (tree / "loro_tpu_torch" / "csrc" / "tree_replay.cu").read_text()
        lib = build_tree(f"tree{i}_replay", src)
        libs[tree] = (lib, lib if hasattr(lib, "tree_replay_launch_timed")
                      else build_tree(f"tree{i}_replay_stamped", instrument_tree(src)))
        print(f"built {tree} tree_replay ({'timed entry: this design' if libs[tree][1] is lib else 'PR 10 design, stamped copy'})",
              flush=True)
    cases = tree_ab_cases(torch, dev) if cases is None else cases
    print(f"tree build and cases {time.perf_counter() - t0:.1f} s", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    load_cycles = tb.smem_load_cycles(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    max_mhz = float(smi.stdout.strip().splitlines()[0])
    print(f"tree latency bound: a dependent shared-memory load {load_cycles:.2f} cycles at {max_mhz:.0f} MHz", flush=True)

    def layout(lib, d, n):
        if hasattr(lib, "tree_replay_launch_timed"):
            plan = tb.plan_replay(d, n, n_sm)
            return int(plan.variant == "smem"), plan.docs_per_warp, plan.stride, f"{plan.variant}, {plan.docs_per_warp} docs a warp"
        use, per, stride = tree_parent_docs_per_cta(n)
        return use, per, stride, f"{'smem' if use else 'global'}, {per} docs a CTA (a thread each)"

    def launch(lib, case, stamps=None):
        target, parent, valid = case["cols"]
        order, n = case["order"], case["n"]
        d, m = target.shape
        use, per, stride, _ = layout(lib, d, n)
        parents = torch.empty((d, n), dtype=torch.int32, device=dev)
        eff = torch.empty((d, m), dtype=torch.bool, device=dev)
        args = [target.data_ptr(), parent.data_ptr(), valid.data_ptr(), None if order is None else order.data_ptr(),
                parents.data_ptr(), eff.data_ptr()]
        rest = [d, m, n, n, use, per, stride, torch.cuda.current_stream(dev).cuda_stream]
        if stamps is not None:
            err = lib.tree_replay_launch_timed(*args, stamps.data_ptr(), *rest)
        else:
            err = lib.tree_replay_launch(*args, *rest)
        if err:
            raise RuntimeError(f"tree launch failed: cudaError {err}")
        return parents, eff

    out = {}
    for case in cases:
        label = case["label"]
        first = None
        for tree in dict.fromkeys(trees):
            got = launch(libs[tree][0], case)
            torch.cuda.synchronize()
            ref = case["want"] if case["want"] is not None else first
            if ref is not None and not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise RuntimeError(f"tree {label}: {tree} kernel != "
                                   + ("plain version" if case["want"] is not None else f"{trees[0]}'s result"))
            first = got if first is None else first
        if case.get("untimed"):
            print(f"tree {label}: every tree == plain version", flush=True)
            continue
        eager, times = zip(*[cs.both_ms(torch, lambda: launch(libs[tree][0], case)) for tree in trees])
        layouts = [layout(libs[tree][0], case["cols"][0].shape[0], case["n"])[3] for tree in trees]
        bound = case["loads"] * load_cycles / (max_mhz * 1e3) if "loads" in case else None
        out[label] = {"ms": list(times), "eager_ms": list(eager), "layout": layouts, "bound_ms": bound}
        print(f"tree {label} ({'; '.join(dict.fromkeys(layouts))}): ms (graph) " + ", ".join(f"{t:.4f}" for t in times)
              + "; eager ms " + ", ".join(f"{t:.4f}" for t in eager)
              + ("" if bound is None else f"; latency bound {bound:.4f} ms ({case['loads']} loads)")
              + ("" if case["want"] is not None else f" (each == {trees[0]}'s result)"), flush=True)
    for case in cases:
        if not case["split"]:
            continue
        d, m = case["cols"][0].shape
        for tree in dict.fromkeys(trees):
            lib, timed = libs[tree]
            _, per, _, desc = layout(lib, d, case["n"])
            rows = []
            for _ in range(3 + 10):
                if timed is lib:
                    st = torch.zeros((-(-d // per), tb.STAMPS), dtype=torch.int64, device=dev)
                    launch(lib, case, st)
                    torch.cuda.synchronize()
                else:
                    launch(timed, case)
                    torch.cuda.synchronize()
                    host = np.zeros((-(-d // per), tb.STAMPS), np.int64)
                    if timed.tree_replay_read_stamps(host.ctypes.data, host.shape[0]):
                        raise RuntimeError("reading the tree stamps failed")
                    st = torch.from_numpy(host)
                rows.append(st.cpu())
            splits = [tb.replay_split(r, d, m, per) for r in rows[3:]]
            med = {k: float(np.median([sp[k] for sp in splits])) for k in splits[0]}
            out.setdefault(f"split {case['label']}", []).append({"tree": str(tree), "layout": desc, **med})
            print(f"tree split {case['label']} {tree} ({desc}; median of 10): " + cs.tree_split_line(med), flush=True)
    return out


def build(tag: str, source: str) -> ctypes.CDLL:
    from loro_tpu_torch import _build

    out_dir = ROOT / "build" / "rank_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{tag}.cu"
    cu.write_text(source)
    so = out_dir / f"lib{tag}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.list_rank_launch.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.list_rank_launch.restype = i32
    if hasattr(lib, "list_rank_launch_timed"):
        lib.list_rank_launch_timed.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.list_rank_launch_timed.restype = i32
    lib.list_rank_wide_launch.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.list_rank_wide_launch.restype = i32
    if hasattr(lib, "list_rank_wyllie_cluster_launch"):
        lib.list_rank_wyllie_cluster_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.list_rank_wyllie_cluster_launch.restype = i32
    if hasattr(lib, "list_rank_wyllie_launch_timed"):
        lib.list_rank_wyllie_launch_timed.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.list_rank_wyllie_launch_timed.restype = i32
    if hasattr(lib, "list_rank_read_stamps"):
        lib.list_rank_read_stamps.argtypes = [ptr, i32]
        lib.list_rank_read_stamps.restype = i32
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("usage: python3 rank_ab.py TREE [TREE ...] (needs an NVIDIA GPU)", file=sys.stderr)
        return 1
    import chip_smoke
    from loro_tpu_torch import tracegen
    from loro_tpu_torch.ops import columnar, fugue_batch, list_rank

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"rank_ab on {torch.cuda.get_device_name(0)} ({card})", flush=True)

    trees = [Path(t).resolve() for t in sys.argv[1:]]
    libs, timed = {}, {}
    t0 = time.perf_counter()
    for i, tree in enumerate(dict.fromkeys(trees)):
        src = (tree / "loro_tpu_torch" / "csrc" / "list_rank.cu").read_text()
        libs[tree] = build(f"tree{i}", src)
        timed[tree] = libs[tree] if hasattr(libs[tree], "list_rank_launch_timed") else build(f"tree{i}_stamped", instrument(src))
        print(f"built {tree} ({'own timed entry' if timed[tree] is libs[tree] else 'stamped copy'})", flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    def has_timed(lib) -> bool:
        return hasattr(lib, "list_rank_launch_timed")

    def own_route(lib, plan, smem) -> str:
        """The table variant a tree runs: "smem" or "global" as asked, or
        for a Wyllie ring past one CTA's shared memory the tree's own
        route ("cluster" where it has the two-CTA kernel, else
        "global"); "wide" for the wide kernel."""
        if plan.wide:
            return "wide"
        if plan.wyllie_split:
            return "cluster" if hasattr(lib, "list_rank_wyllie_cluster_launch") else "global"
        return "smem" if smem else "global"

    def launch(lib, plan, succ_p, w_p, smem, stamps=None):
        """One launch of a tree's packed kernel in the given table
        variant (each tree sizes its own table; scratch of 2 mp words a
        ring covers every layout)."""
        d = succ_p.shape[0]
        dist = torch.empty_like(succ_p)
        route = own_route(lib, plan, smem)
        if route == "wide":
            err = lib.list_rank_wide_launch(succ_p.data_ptr(), w_p.data_ptr(), dist.data_ptr(), d, plan.mp,
                                            plan.n_steps, plan.exit_ring_slots, plan.cluster, plan.smem_bytes,
                                            torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return dist
        if route == "cluster":
            mirror = torch.empty(d * plan.mp, dtype=torch.int32, device=dev)
            err = lib.list_rank_wyllie_cluster_launch(succ_p.data_ptr(), w_p.data_ptr(), dist.data_ptr(),
                                                      mirror.data_ptr(), d, plan.mp, plan.n_steps, plan.smem_bytes,
                                                      torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return dist
        smem = route == "smem"
        scratch = None if smem else torch.empty(d * 2 * plan.mp, dtype=torch.int32, device=dev)
        args = [succ_p.data_ptr(), w_p.data_ptr(), dist.data_ptr(), None if scratch is None else scratch.data_ptr()]
        shape = [d, plan.mp, plan.n_steps, plan.n_steps_dense if plan.ruling else 0]
        rest = [plan.k.bit_length() - 1, plan.n_steps_a, plan.block.bit_length() - 1, int(smem),
                torch.cuda.current_stream(dev).cuda_stream]
        if stamps is not None and has_timed(lib):
            err = lib.list_rank_launch_timed(*args, stamps.data_ptr(), *shape, *rest)
        else:
            err = lib.list_rank_launch(*args, *shape, int(plan.ruling), *rest)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return dist

    def phase_cycles(lib, plan, succ_p, w_p):
        rows = []
        for _ in range(3 + 20):
            stamps = torch.zeros((succ_p.shape[0], STAMPS), dtype=torch.int64, device=dev)
            launch(lib, plan, succ_p, w_p, True, stamps)
            torch.cuda.synchronize()
            if not has_timed(lib):
                host = np.zeros((succ_p.shape[0], STAMPS), np.int64)
                if lib.list_rank_read_stamps(host.ctypes.data, succ_p.shape[0]):
                    raise RuntimeError("reading the stamps failed")
                stamps = torch.from_numpy(host)
            rows.append(stamps.cpu())
        st = torch.cat(rows[3:]).double()
        return [float(v) for v in (st[:, 1:6] - st[:, 0:5]).median(dim=0).values]

    docs = tracegen.fleet_docs(2, seed=chip_smoke.SEED)
    pad_n = -(-max(d.extract.n for d in docs) // 8192) * 8192
    pad_c = -(-max(columnar.contract_chains(d.extract).n_chains for d in docs) // 1024) * 1024
    batch = columnar.stack_docs([columnar.chain_columns(docs[j % len(docs)].extract, pad_n=pad_n, pad_c=pad_c)
                                 for j in range(CHUNK)])
    cols = fugue_batch.chain_columns_to_torch(batch, device=dev)
    flag, _ = fugue_batch._ring_and_anchors(cols.c_parent, cols.c_side, cols.c_valid)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    full = flag[torch.arange(n_sm, device=dev) % CHUNK].contiguous()
    over = 1024
    while list_rank.plan_rank(over + 1024).smem_bytes:
        over += 1024
    over += 1  # the first ring past the ruling table's shared-memory budget
    gap = torch.as_tensor(np.stack([chip_smoke.gap_ring(np, 65536, 8)] * CHUNK)).to(dev)
    rand_over = torch.as_tensor(np.stack([chip_smoke.random_ring(np, over, 70 + i) for i in range(CHUNK)])).to(dev)
    w_over = list_rank.SMEM_LIMIT // 4 + 1  # the first ring past the wyllie table's budget
    wrand_over = torch.as_tensor(np.stack([chip_smoke.random_ring(np, w_over, 90 + i) for i in range(CHUNK)])).to(dev)
    rand_full = torch.as_tensor(np.stack([chip_smoke.random_ring(np, 65536, 110 + i) for i in range(CHUNK)])).to(dev)
    edocs = tracegen.fleet_docs(2, n_patches=chip_smoke.ELEMENT_PATCHES, seed=chip_smoke.SEED)
    eseq = fugue_batch.stack_seq_columns([edocs[j % len(edocs)].extract for j in range(CHUNK)], chip_smoke.ELEMENT_N)
    ecols = fugue_batch.seq_columns_to_torch(eseq, device=dev)
    element, _ = fugue_batch._ring_and_anchors(ecols.parent, ecols.side, ecols.valid)
    cases = [(f"flagship [{CHUNK}, {flag.shape[1]}]", flag, algo, True) for algo in ("ruling", "blocked", "wyllie")]
    cases += [(f"flagship cycled [{n_sm}, {flag.shape[1]}]", full, algo, True) for algo in ("ruling", "blocked", "wyllie")]
    cases += [(f"gap ring [{CHUNK}, 65536]", gap, algo, False) for algo in ("ruling", "blocked")]
    cases += [(f"random ring over the smem budget [{CHUNK}, {over}]", rand_over, algo, False)
              for algo in ("ruling", "blocked")]
    cases += [(f"random ring over the smem budget [{CHUNK}, {w_over}]", wrand_over, "wyllie", False),
              (f"gap ring [{CHUNK}, 65536]", gap, "wyllie", False),
              (f"random ring [{CHUNK}, 65536]", rand_full, "wyllie", False),
              (f"element rings [{CHUNK}, {element.shape[1]}]", element, "wide", True)]

    out = {"card": card, "kind": torch.cuda.get_device_name(0), "trees": [str(t) for t in trees], "cases": {}}
    for label, succ, algo, smem in cases:
        plan, succ_p, w_p = list_rank._prepare(succ, None, "ruling" if algo == "wide" else algo, 8, None)
        if plan.wide != (algo == "wide"):
            raise RuntimeError(f"{label}: {algo} case on a plan with wide={plan.wide}")
        want = list_rank.rank_plain(succ_p, w_p, plan)
        for tree in dict.fromkeys(trees):
            got = launch(libs[tree], plan, succ_p, w_p, smem)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} {algo}: {tree} kernel != plain version")
        eager, times = zip(*[chip_smoke.both_ms(torch, lambda: launch(libs[tree], plan, succ_p, w_p, smem))
                             for tree in trees])
        routes = [own_route(libs[tree], plan, smem) for tree in trees]
        bound = 12 * succ_p.shape[0] * plan.mp / HBM_BYTES_PER_S * 1e3
        key = f"{algo} {label}"
        out["cases"][key] = {"ms": list(times), "eager_ms": list(eager), "table": routes, "bound_ms": bound}
        print(f"{key} (tables {', '.join(dict.fromkeys(routes))}): ms (graph) " + ", ".join(f"{t:.4f}" for t in times)
              + "; eager ms " + ", ".join(f"{t:.4f}" for t in eager) + f"; bound {bound:.5f} ms (bytes)", flush=True)
    fplan = {algo: list_rank._prepare(flag, None, algo, 8, None) for algo in ("ruling", "blocked")}
    for algo, (plan, succ_p, w_p) in fplan.items():
        per_tree = [phase_cycles(timed[tree], plan, succ_p, w_p) for tree in trees]
        out["cases"][f"{algo} phases"] = {"phases": list(list_rank.PHASES), "cycles": per_tree}
        for tree, cyc in zip(trees, per_tree):
            print(f"phases {algo} [{CHUNK}, {plan.mp}] {tree}: cycles per CTA (median of 20 x {CHUNK}): "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(list_rank.PHASES, cyc)) + f"; total {sum(cyc):.0f}",
                  flush=True)
    # Wyllie's rounds on the flagship rings, for trees with the timed entry
    plan, succ_p, w_p = list_rank._prepare(flag, None, "wyllie", 8, None)
    for tree in trees:
        lib = libs[tree]
        if not hasattr(lib, "list_rank_wyllie_launch_timed"):
            continue
        rows = []
        for _ in range(3 + 20):
            stamps = torch.zeros((CHUNK, list_rank.WYLLIE_STAMPS), dtype=torch.int64, device=dev)
            dist = torch.empty_like(succ_p)
            err = lib.list_rank_wyllie_launch_timed(succ_p.data_ptr(), w_p.data_ptr(), dist.data_ptr(), None,
                                                    stamps.data_ptr(), CHUNK, plan.mp, plan.n_steps, 1, 1, 0,
                                                    torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"timed wyllie launch failed: cudaError {err}")
            rows.append(stamps)
        torch.cuda.synchronize()
        info = list_rank.wyllie_rounds(torch.cat(rows[3:]))
        out["cases"].setdefault("wyllie rounds", []).append({"tree": str(tree), **info})
        print(f"wyllie rounds [{CHUNK}, {plan.mp}] {tree}: rounds {info['rounds']}, load {info['load_cycles']:.0f}, "
              f"rounds {info['rounds_cycles']:.0f}, store {info['store_cycles']:.0f} cycles; per round "
              + " ".join(f"{c:.0f}" for c in info["round_cycles"]), flush=True)
    out["tree"] = tree_ab(torch, dev, trees, card)
    print("rank_ab " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
