"""The benchmark's harness, driven by data.

``run`` finds everything by name: the cell in ``BENCHMARK.json``, its
file ``cells/<cell>.json`` (the driver), the configuration's file, the
traffic mix ``mixes/<traffic>.json``, the driver ``drivers/<driver>.py``
and one reader ``metrics/<metric>.py`` a metric.  A later cell, mix,
driver or metric is a new file and needs no edit here.

A run: the driver's set-up (data, the program, a warm call of every
shape), then the measured window of ``seconds`` (timed steps one after
another; with ``trace`` the readers' wrappers record and ``torch.profiler``
traces the host and the card; untraced, a device-only profile is taken
where an end-to-end metric reads the card's kernel time), then the
program's last reads, the memory peak, the program's state freed, and
the comparison with the plain reference.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from .probe import Probe
from .timing import STEP_LABEL, WINDOW_LABEL, card_line, kernel_busy_s, reduce_trace

ROOT = Path(__file__).resolve().parent.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "loro_tpu")  # top-level module names, compared whole


class Context:
    """What a driver gets: the run's arguments, its cell, configuration
    and mix, the device, the cache directory, the probe and a log."""

    def __init__(self, *, workload: str, seed: int, seconds: float, trace: bool, device, cell: dict,
                 config: dict, mix: dict, cache_dir: Path, probe: Probe, log: Callable[[str], None]):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.cell, self.config, self.mix = device, cell, config, mix
        self.cache_dir, self.probe, self.log = cache_dir, probe, log


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plan(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, files and per-layer metrics, by name."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    wl = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == wl["config"])
    bdir = root / "portbench"
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {
        "entry": wl, "end_to_end": e2e, "per_layer": per_layer,
        "cell": _read_json(bdir / "cells" / f"{workload}.json"),
        "config": _read_json(root / config["file"]),
        "mix": _read_json(bdir / "mixes" / f"{wl['traffic']}.json"),
        "dir": bdir,
    }


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t_start: Optional[float] = None,
        root: Path = ROOT, cache_dir: Optional[Path] = None, mix_overrides: Optional[dict] = None,
        config_overrides: Optional[dict] = None, driver_factory=None, log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run of a cell; returns the result line's object, or raises.
    `device="cpu"` (the tests' rehearsal) runs the same path on the CPU
    and reports no device metric; `driver_factory(ctx)` stands in for
    the cell's driver (the controls and the fault tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    p = plan(workload, root)
    mix = dict(p["mix"], **(mix_overrides or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    probe = Probe(torch, cuda)
    ctx = Context(workload=workload, seed=seed, seconds=seconds, trace=trace, device=dev, cell=p["cell"],
                  config=dict(p["config"], **(config_overrides or {})), mix=mix,
                  cache_dir=cache_dir or root / "build" / "portbench" / "data", probe=probe, log=log)
    if cuda:
        log(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {card_line()}")
    # one reader a metric: the cell's end-to-end metrics untraced, its
    # per-layer metrics traced; only a traced run wraps anything
    readers: Dict[str, Tuple[ModuleType, str]] = {}
    for m in p["per_layer"] if trace else p["end_to_end"]:
        r = _load_file(p["dir"] / "metrics" / f"{m['name']}.py", "portbench_metric_" + m["name"].replace(".", "_"))
        if getattr(r, "DEVICE", False) and not cuda:
            continue  # a device metric is never read from a CPU run
        if r.WRAPS and not trace:
            raise ValueError(f"end-to-end metric {m['name']} wraps the program: only a traced run may")
        for w in r.WRAPS:
            probe.want(**w)
        readers[m["name"]] = (r, m["unit"])
    if trace:
        probe.install()
    if driver_factory is None:
        driver_factory = _load_file(p["dir"] / "drivers" / f"{p['cell']['driver']}.py",
                                    "portbench_driver_" + p["cell"]["driver"]).Driver
    try:
        drv = driver_factory(ctx)
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        prof = None
        acts = torch.profiler.ProfilerActivity
        if trace and cuda:
            prof = torch.profiler.profile(activities=[acts.CPU, acts.CUDA])
        elif cuda and any(getattr(r, "PROFILE", False) for r, _ in readers.values()):
            prof = torch.profiler.profile(activities=[acts.CUDA])  # the card's own clock, nothing wrapped
        if prof is not None:
            prof.__enter__()
        ops = 0
        with torch.profiler.record_function(WINDOW_LABEL) if trace and prof is not None else nullcontext():
            probe.open = True
            t0 = time.perf_counter()
            while True:
                probe.step += 1
                s0 = time.perf_counter()
                with torch.profiler.record_function(STEP_LABEL) if trace and prof is not None else nullcontext():
                    ops += drv.step()
                t1 = time.perf_counter()
                probe.step_ms.append((t1 - s0) * 1e3)
                if t1 - t0 >= seconds:
                    break
            probe.open = False
        window_s = t1 - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            if trace:
                probe.trace = reduce_trace(prof, torch)
            else:
                busy = kernel_busy_s(prof, torch)
                probe.trace = None if busy is None else {"kernel_busy_s": busy}
            del prof
        drv.finish()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        drv.release()
    finally:
        probe.uninstall()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chk = drv.check()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX package or JAX are loaded: {found}")

    probe.ops, probe.window_s, probe.setup_s = ops, window_s, setup_s
    metrics = {}
    for name, (r, unit) in readers.items():
        v = r.read(probe)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": chk["correct"], "attempted": chk["attempted"], "failed": chk["failed"],
              "metrics": metrics, "device": device_info}
    if trace and probe.trace is not None:
        device_info["busy_s"] = probe.trace["busy_s"]
        device_info["window_s"] = probe.trace["trace_window_s"]
        result["breakdown"] = {"device_ops": probe.trace["device_ops"], "idle_gaps": probe.trace["idle_gaps"]}
    result["compared"] = chk["compared"]
    log(f"window: {len(probe.step_ms)} steps, {ops} ops in {window_s:.3f} s; set-up {setup_s:.3f} s")
    log("step ms: " + " ".join(f"{ms:.1f}" for ms in probe.step_ms))
    for name, c in chk["compared"].items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    return result

