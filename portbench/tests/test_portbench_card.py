"""On the card: each cell's command, at its own size with a short
window, prints a correct result: untraced, with every end-to-end metric
the cell lists; traced, with every per-layer metric it lists, device
shares inside 0-100 % and the device's busy time."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["text_import.full4"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(workload, trace, cuda_card):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 77),
                          "--seconds", "4", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["compared"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert r["device"]["platform"] == "gpu"
    if not trace:
        want = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
        assert set(r["metrics"]) == want and all(m["value"] > 0 for m in r["metrics"].values())
        return
    want = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
    assert want <= set(r["metrics"])
    for name in ("rank_roofline", "device_idle_pct"):
        if name in r["metrics"]:
            assert 0 < r["metrics"][name]["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert len(r["breakdown"]["device_ops"]) > 0
