"""A CPU rehearsal of each cell through its own driver at a tiny size,
untraced and traced; the discovery of a new cell and metric from files
alone; and a checkout without the program."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import TINY, tiny_run

ROOT = Path(__file__).resolve().parents[2]
DEVICE_METRICS = {"kernel_ms_per_Mop", "import.device_busy_ms", "rank_roofline", "device_idle_pct"}


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearses_on_the_cpu(workload, trace, tiny_cache):
    r = tiny_run(workload, tiny_cache, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "compared" and r["compared"]["wrong_texts"] == {"value": 0, "limit": 0}
    assert r["device"]["platform"] == "cpu" and "busy_s" not in r["device"]
    assert not DEVICE_METRICS & set(r["metrics"])  # no CPU number under a device metric's name
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:
        want = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]} - DEVICE_METRICS
        assert want <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"setup_s"}  # kernel_ms_per_Mop is the card's alone
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_same_seed_same_inputs(tiny_cache):
    from portbench import harness

    drivers = []
    for _ in range(2):
        p = harness.plan("text_import.full4")
        mix, config = TINY["text_import.full4"]
        ctx = harness.Context(workload="text_import.full4", seed=2**31 + 5, seconds=0, trace=False, device=None,
                              cell=p["cell"], config={**p["config"], **config}, mix={**p["mix"], **mix},
                              cache_dir=tiny_cache, probe=None, log=lambda m: None)
        drivers.append(harness._load_file(p["dir"] / "drivers" / "fleet_import.py", "d").Driver(ctx))
    a, b = drivers
    assert [[pl for _, pl in bt] for bt in a.batches] == [[pl for _, pl in bt] for bt in b.batches]
    payloads = [pl for bt in a.batches for _, pl in bt]
    assert len(set(payloads)) == len(payloads)


def test_a_new_cell_and_metric_are_found_from_new_files(tmp_path, tiny_cache):
    """Add a configuration, a cell, its mix and a per-layer metric as new
    files in a copy, with their entries in BENCHMARK.json, and run them:
    no other edit."""
    from portbench import harness

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "text_tiny", "source": "a test", "file": "portbench/configs/text_tiny.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": "text_import.tiny", "config": "text_tiny", "traffic": "tiny", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "import.calls", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "fleet host prep", "moves": "kernel_ms_per_Mop", "workloads": ["text_import.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix, config = TINY["text_import.full4"]
    config = {**json.loads((ROOT / "portbench/configs/text_import.json").read_text()), **config}
    (tmp_path / "portbench/configs/text_tiny.json").write_text(json.dumps(config))
    mix = {**json.loads((ROOT / "portbench/mixes/full4.json").read_text()), **mix}
    (tmp_path / "portbench/mixes/tiny.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/cells/text_import.tiny.json").write_text(json.dumps({"driver": "fleet_import"}))
    (tmp_path / "portbench/metrics/import.calls.py").write_text(
        "WRAPS = [{'target': 'loro_tpu_torch.parallel.fleet:Fleet.merge_text_payloads'}]\n"
        "def read(probe):\n    return float(len(probe.calls['loro_tpu_torch.parallel.fleet:Fleet.merge_text_payloads']))\n")
    r = harness.run("text_import.tiny", 7, 0.2, True, device="cpu", root=tmp_path, cache_dir=tiny_cache,
                    log=lambda m: None)
    assert r["correct"] and r["metrics"]["import.calls"]["value"] >= 1
    assert set(r["metrics"]) == {"import.calls"}  # the other metrics list other cells


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\nfrom portbench import harness\n"
            "print(harness.run('text_import.full4', 1, 0.1, False, device='cpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "loro_tpu_torch" in res.stderr
