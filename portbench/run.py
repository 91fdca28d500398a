"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; and last, under
``compared``, each number the correctness check compared with its limit,
which are also the last lines of standard error.  Without a CUDA card,
or with JAX or the JAX package loaded once the window has closed, it
exits with code 1 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card is visible; nothing measured", file=sys.stderr)
        return 1
    from portbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    except RuntimeError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
