#!/usr/bin/env python3
"""Compares the one-CTA packed list-rank kernels of several source trees
on one NVIDIA GPU, in turns, in one process.

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
- ruling and blocked on the flagship rings cycled over one ring per SM;
- ruling and blocked on the adversarial ruler-gap ring (m = 65,536) and
  on a random ring just over the ruling table's shared-memory budget, 8
  rings each, both in the global-scratch table variant;
- per-phase cycles (thread 0's clock64 after each phase's barrier) of
  ruling and blocked on the flagship rings: the tree's timed entry point
  (list_rank_launch_timed) where it has one, else a copy of its source
  with stamps written in after the phase barriers (the packed kernel as
  it stood before that entry point existed; `instrument` finds them).

Times: CUDA events over 20 back-to-back launches, median of 20 samples
after 3 warm-ups (chip_smoke.time_ms).  Prints one line per case and a
final `rank_ab {...}` JSON line, with the card's name and power limit.
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

    def launch(lib, plan, succ_p, w_p, smem, stamps=None):
        """One launch of a tree's packed kernel in the given table
        variant (each tree sizes its own table; scratch of 2 mp words a
        ring covers every layout)."""
        d = succ_p.shape[0]
        scratch = None if smem else torch.empty(d * 2 * plan.mp, dtype=torch.int32, device=dev)
        dist = torch.empty_like(succ_p)
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
    cases = [(f"flagship [{CHUNK}, {flag.shape[1]}]", flag, algo, True) for algo in ("ruling", "blocked", "wyllie")]
    cases += [(f"flagship cycled [{n_sm}, {flag.shape[1]}]", full, algo, True) for algo in ("ruling", "blocked")]
    cases += [(f"gap ring [{CHUNK}, 65536]", gap, algo, False) for algo in ("ruling", "blocked")]
    cases += [(f"random ring over the smem budget [{CHUNK}, {over}]", rand_over, algo, False)
              for algo in ("ruling", "blocked")]

    out = {"card": card, "kind": torch.cuda.get_device_name(0), "trees": [str(t) for t in trees], "cases": {}}
    for label, succ, algo, smem in cases:
        plan, succ_p, w_p = list_rank._prepare(succ, None, algo, 8, None)
        want = list_rank.rank_plain(succ_p, w_p, plan)
        for tree in dict.fromkeys(trees):
            got = launch(libs[tree], plan, succ_p, w_p, smem)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} {algo}: {tree} kernel != plain version")
        times = [chip_smoke.time_ms(torch, lambda: launch(libs[tree], plan, succ_p, w_p, smem), inner=20)
                 for tree in trees]
        bound = 12 * succ_p.shape[0] * plan.mp / HBM_BYTES_PER_S * 1e3
        key = f"{algo} {label}"
        out["cases"][key] = {"ms": times, "table": "smem" if smem else "global", "bound_ms": bound}
        print(f"{key} ({'smem' if smem else 'global'} table): ms " + ", ".join(f"{t:.4f}" for t in times)
              + f"; bound {bound:.5f} ms (bytes)", flush=True)
    fplan = {algo: list_rank._prepare(flag, None, algo, 8, None) for algo in ("ruling", "blocked")}
    for algo, (plan, succ_p, w_p) in fplan.items():
        per_tree = [phase_cycles(timed[tree], plan, succ_p, w_p) for tree in trees]
        out["cases"][f"{algo} phases"] = {"phases": list(list_rank.PHASES), "cycles": per_tree}
        for tree, cyc in zip(trees, per_tree):
            print(f"phases {algo} [{CHUNK}, {plan.mp}] {tree}: cycles per CTA (median of 20 x {CHUNK}): "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(list_rank.PHASES, cyc)) + f"; total {sum(cyc):.0f}",
                  flush=True)
    print("rank_ab " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
