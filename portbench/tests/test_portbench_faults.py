"""The comparison has to fail: each cell's control (the reference in the
program's place with a guarantee broken) and each fault a cell can have,
planted in the program underneath a whole run with the harness's look
for a card skipped, make ``correct`` come out false."""
import pytest

from conftest import TINY, tiny_run


def _driver(workload):
    from portbench import harness

    p = harness.plan(workload)
    name = p["cell"]["driver"]
    return name, harness._load_file(p["dir"] / "drivers" / f"{name}.py", "portbench_driver_" + name).Driver


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_is_not_correct(workload, tiny_cache):
    from portbench.reference.control import CONTROLS, control_driver

    name, drv = _driver(workload)
    r = tiny_run(workload, tiny_cache, driver_factory=control_driver(drv, CONTROLS[name]))
    assert r["correct"] is False and r["compared"]["wrong_texts"]["value"] > 0


def _alter_one_text(monkeypatch):
    """A token altered where it is produced: the first text's first
    character, in the fleet's decode of the fetched codes."""
    import loro_tpu_torch.parallel.fleet as fleet

    real = fleet.texts_of

    def texts_of(codes, counts, d):
        out = real(codes, counts, d)
        if out and out[0]:
            out[0] = chr(ord(out[0][0]) ^ 1) + out[0][1:]
        return out

    monkeypatch.setattr(fleet, "texts_of", texts_of)


def _half_the_batch(monkeypatch):
    """Half of the batch left out: the import merges the first half and
    repeats its texts for the rest."""
    from loro_tpu_torch.parallel.fleet import Fleet, TextMergeResult

    real = Fleet.merge_text_payloads

    def merge(self, payloads, cid):
        half = real(self, payloads[: max(1, len(payloads) // 2)], cid).texts
        return TextMergeResult((half * 2)[: len(payloads)])

    monkeypatch.setattr(Fleet, "merge_text_payloads", merge)


# a step that returns its state unchanged has no analogue in an import,
# which holds no state, and no cell exchanges between chips
FAULTS = [("text_import.full4", "altered"), ("text_import.full4", "half")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault, tiny_cache, monkeypatch):
    if fault == "altered":
        _alter_one_text(monkeypatch)
    else:
        _half_the_batch(monkeypatch)
    r = tiny_run(workload, tiny_cache)
    assert r["correct"] is False and r["compared"]["wrong_texts"]["value"] > 0
