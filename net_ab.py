"""Phase 4p of chip_smoke.py three times in one process on one NVIDIA GPU:
the interpreter's thread switch interval (sys.setswitchinterval) at its
5 ms default, at 0.5 ms, then at 5 ms again.  The network edge's pulls and
pushes hop between a client thread, the NetServer's loop thread, its
executor pool and the read batcher, so each hop waits for the interpreter
lock; this shows how much of a pull or a push that wait is.

    python3 net_ab.py        # prints one line a run, then "ab {...}"

Compare the runs only within one call, and the two 5 ms runs with each
other first: their spread is the noise.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from loro_tpu_torch import _build  # noqa: E402

RUNS = (("5ms", 0.005), ("0.5ms", 0.0005), ("5ms_again", 0.005))
A_KEYS = ("pushes_per_s", "push_to_ack_p50_ms", "push_to_ack_p99_ms", "pulls_per_s", "pulls_a_window", "windows",
          "fanin_worker_ms_a_push", "p2a_stage_mean_ms")
B_KEYS = ("pulls_per_s", "pulls_a_window", "rounds_per_s", "catch_up_ms_by_part", "apply_lag_p50_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("net_ab: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.build_all()
    dev, kind = torch.device("cuda:0"), torch.cuda.get_device_name(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    res = {}
    for label, interval in RUNS:
        sys.setswitchinterval(interval)
        out = cs.net_phase(torch, dev, kind, card)
        res[label] = {k: out["a"][k] for k in A_KEYS}
        res[label].update({"f_" + k: out["b"][k] for k in B_KEYS})
        res[label]["seconds"] = out["seconds"]
        print(label, json.dumps(res[label]), flush=True)
    print(card)
    print("ab " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
