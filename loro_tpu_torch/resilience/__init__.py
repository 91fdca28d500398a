"""loro_tpu_torch.resilience: supervised device execution, fault
injection and host degradation for the port's fleet merges (the port of
loro_tpu/resilience).

- ``supervisor``  — DeviceSupervisor: bounded in-flight launch budget
  with fetch drains, cooperative deadlines (checked BETWEEN launches),
  bounded retry with exponential backoff for transient errors, and
  typed DeviceFailure for every device error (a CUDA error, an
  out-of-memory, a failed kernel launch, an armed fault); everything
  else, a kernel that does not build among it, passes through;
- ``probe``       — the staggered never-signaled backend probe ladder
  (``wait_for_backend``) and the cheap ``tunnel_alive`` check;
- ``faultinject`` — env (``LORO_FAULT=...``) and programmatic fault
  hooks at the ``launch``, ``fetch``, ``decode``, ``backend_init`` and
  ``export_launch`` sites, so every degradation path runs on the CPU;
- ``hostpath``    — the host engine a one-shot merge re-runs on under an
  armed fault (exactly the device result, by the differential tests); a
  real device failure reaches the caller as DeviceFailure.

All outcomes report through the ``obs`` registry (``resilience.*``,
``probe.*``, ``faultinject.*``), the flight recorder and
``DeviceSupervisor.report()``.
"""
from __future__ import annotations

from ..errors import (
    BackendUnavailable,
    DeadlineExceeded,
    DeviceFailure,
    ResilienceError,
)
from . import faultinject, hostpath, probe
from .probe import read_status, start_probe, tunnel_alive, wait_for_backend
from .supervisor import (
    DeviceSupervisor,
    RetryPolicy,
    default_transient,
    get_supervisor,
    set_supervisor,
)

__all__ = [
    "BackendUnavailable",
    "DeadlineExceeded",
    "DeviceFailure",
    "DeviceSupervisor",
    "ResilienceError",
    "RetryPolicy",
    "default_transient",
    "faultinject",
    "get_supervisor",
    "hostpath",
    "probe",
    "read_status",
    "set_supervisor",
    "start_probe",
    "tunnel_alive",
    "wait_for_backend",
]
