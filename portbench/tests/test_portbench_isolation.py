"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``loro_tpu_torch`` is not ``loro_tpu``), and
the reference and the generator load nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_harness_drivers_and_readers_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import run, harness, traffic, textgen, timing, probe\n"
        "from portbench.reference import fugue, control\n"
        "import glob\n"
        "for f in sorted(glob.glob('portbench/drivers/*.py') + glob.glob('portbench/metrics/*.py')):\n"
        "    harness._load_file(harness.Path(f), 'm_' + f.replace('/', '_').replace('.', '_'))\n"
        "import loro_tpu_torch.parallel.fleet\n"
    )
    assert not _modules_after(code) & set(FORBIDDEN)


def test_the_reference_and_the_generator_load_nothing_of_the_program():
    code = "import sys; sys.path.insert(0, '.')\nfrom portbench import textgen, traffic\nfrom portbench.reference import fugue, control\n"
    assert not _modules_after(code) & {"loro_tpu_torch", *FORBIDDEN}


def test_a_names_check_is_whole():
    from portbench import harness

    assert "loro_tpu_torch" not in FORBIDDEN and "loro_tpu" in FORBIDDEN
    assert harness.forbidden_modules() == sorted(
        {m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def test_without_a_card_the_command_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would measure")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "text_import.full4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
