"""Tests of the benchmark harness.  CPU tests run the harness's own path
at tiny sizes on ``device="cpu"``; tests that need the card carry the
``cuda`` marker and skip, deciding inside a fixture, without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a tiny fleet: the cell's shape (4 peers, sync epochs, whole histories), small
TINY_PATCHES = 6000
TINY_INSERTS = round(TINY_PATCHES * 182_315 / 259_778)  # the generator keeps the trace's ratio
TINY_CONFIG = {"patches_per_doc": TINY_PATCHES, "inserts_per_doc": TINY_INSERTS,
               "deletes_per_doc": TINY_PATCHES - TINY_INSERTS, "sync_every": 1000, "fleet_docs": 8}
TINY = {"text_import.full4": ({"pool": 3, "orders_per_base": 2, "docs_per_call": 4}, TINY_CONFIG)}

def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips with a reason on a machine without one")


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    """One cache directory for the tiny pool, shared by every test of a run."""
    return tmp_path_factory.mktemp("portbench_data")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def tiny_run(workload, cache, seed=2**31 + 11, trace=False, seconds=0.2, **kw):
    from portbench import harness

    mix, config = TINY[workload]
    return harness.run(workload, seed, seconds, trace, device="cpu", cache_dir=cache, mix_overrides=mix,
                       config_overrides=config, log=lambda msg: None, **kw)
