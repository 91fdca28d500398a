#!/usr/bin/env python3
"""Times the tree replay's plain version (tree_batch.replay_plain) on one
NVIDIA GPU and on its host's CPU, on the same columns, in one process.

replay_plain is a Python loop over moves with an inner loop while any doc
still walks: a dozen small torch ops a step, and on the card a host read
a step.  chip_smoke.py holds the replay kernel against it; this script
says on which device that check is quicker.  Cases (seeded columns, all
valid): random moves at [1,024, 1,024] on 512 nodes; deep chains at
[8, 2,048] on 2,048 nodes (each move's parent 1-3 below its target); and
the permutation form at [1,024, 1,024] on 1,024 nodes (each doc's rows
shuffled, the order given).  Each case runs once a device; the results
must be equal.  Prints one JSON line a run and the card's name and power
limit.  Usage:
    python3 plain_ab.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from loro_tpu_torch.ops import tree_batch as tb  # noqa: E402


def cases(rng):
    d, m, n = 1024, 1024, 512
    rand = (rng.integers(0, n, (d, m)), rng.integers(-2, n, (d, m)), None)
    d, m, n2 = 8, 2048, 2048
    tgt = rng.integers(0, n2, (d, m))
    deep = (tgt, np.maximum(tgt - rng.integers(1, 4, (d, m)), -1), None)
    d, m, n3 = 1024, 1024, 1024
    perm = (rng.integers(0, n3, (d, m)), rng.integers(-2, n3, (d, m)), np.argsort(rng.random((d, m)), axis=1))
    return [(f"random [1024, 1024] n {n}", rand, n), (f"deep [8, 2048] n {n2}", deep, n2),
            (f"permuted [1024, 1024] n {n3}", perm, n3)]


def main() -> int:
    if not torch.cuda.is_available():
        print("plain_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    ok = True
    for label, (t, p, order), n in cases(np.random.default_rng(5)):
        ref = None
        for dev in (torch.device("cuda"), torch.device("cpu")):
            cols = [torch.from_numpy(t.astype(np.int32)).to(dev), torch.from_numpy(p.astype(np.int32)).to(dev),
                    torch.ones(t.shape, dtype=torch.bool, device=dev)]
            o = None if order is None else torch.from_numpy(order).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tb.replay_plain(*cols, n, order=o)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            got = [x.cpu() for x in got]
            ref = ref or got
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            ok = ok and same
            print(json.dumps({"case": label, "device": dev.type, "s": s, "same": same}), flush=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
