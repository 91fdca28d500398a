"""Device timing for the traced run: the card's published peaks and the
reduction of a ``torch.profiler`` trace to busy time, the longest idle
gaps and the device operations that took most time.

The device-row rule (kernel and copy rows only, since an aten op's row
repeats its kernels' time) is copied from the port's bring-up script
(``chip_smoke.device_breakdown``); busy time here is the union of the
device intervals, not their sum, so overlapping streams count once.
"""
from __future__ import annotations

import subprocess
from typing import Dict, List, Optional, Tuple

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit)
PEAKS: Dict[str, float] = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
}
# the port's kernel-table rule for ranking a ring: 12 bytes a ring token
# (the int32 successor and weight read once, the int32 distance written once)
RANK_BYTES_PER_TOKEN = 12

WINDOW_LABEL = "portbench.window"
STEP_LABEL = "portbench.step"  # one timed step: the host's work outside the wrapped calls


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def _is_note(name: str) -> bool:
    """An annotation of the harness's (the window, a step, a wrapped call)."""
    return name.startswith("portbench.") or name.startswith("loro_tpu_torch.")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def kernel_busy_s(prof, torch) -> Optional[float]:
    """The union of the kernel intervals (copies left out: a pageable
    copy's span on the card follows the host's staging) of a finished
    profile that spans the window alone (the untraced run's device-only
    profile); None if it holds none."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
           if e.device_type == cuda and not _is_note(e.name) and not _is_copy(e.name)
           and e.time_range.end > e.time_range.start]
    return sum(b - a for a, b in _merge(dev)) / 1e6 if dev else None


def reduce_trace(prof, torch, top: int = 10) -> Optional[dict]:
    """busy_s (union of device intervals), trace_window_s (the window's
    annotation), device_ops (the `top` device rows by time) and
    idle_gaps (the `top` longest stretches of the window with nothing on
    the device, each named by the innermost annotated host call that was
    running in its middle) from a finished profile; None if it holds no
    device interval."""
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[float, float]] = []
    notes: List[Tuple[float, float, str]] = []
    window = None
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        note = _is_note(e.name)
        if e.device_type == cuda:
            # a host annotation is mirrored on the device's timeline as a
            # span that covers its kernels and the gaps between them
            if not note and b > a:
                dev.append((a, b))
        elif e.name == WINDOW_LABEL:
            window = (a, b)
        elif note:
            notes.append((a, b, e.name))
    if not dev or window is None:
        return None
    w0, w1 = window
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            gaps.append((a - last, last, a))
        last = max(last, b)
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        inside = [(s, n) for s, e, n in notes if s <= mid <= e]
        idle.append([max(inside)[1] if inside else "host", length / 1e6])
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda or _is_note(e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e6, e.key[:160]))
    rows.sort(reverse=True)
    return {
        "busy_s": busy_us / 1e6,
        "trace_window_s": (w1 - w0) / 1e6,
        "device_ops": [[name, s] for s, name in rows[:top]],
        "idle_gaps": idle,
    }
