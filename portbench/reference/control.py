"""The controls of the comparison: the plain reference put in the
program's place with one guarantee of the configuration broken.  A
control has to come out as not correct; ``portbench/control.py`` runs it
at a cell's own size, ``tests/test_portbench_faults.py`` at a small one.

- ``ArrivalFleet`` (bulk import): texts with concurrent siblings in the
  order the inserts arrived, not by (peer id, counter): a text that does
  not converge, so it breaks "every text returned is the converged
  Fugue text of its payload".
"""
from __future__ import annotations

from typing import List

from .fugue import TextReference


class ArrivalFleet:
    def __init__(self, driver):
        self.ref = TextReference([b.events for b in driver.pool], sibling="arrival")

    def merge(self, batch) -> List[str]:
        return [self.ref.text(doc.base, doc.peer_ids) for doc, _ in batch]


CONTROLS = {"fleet_import": ArrivalFleet}


def control_driver(driver_cls, control_cls):
    """`driver_cls` with `control_cls(driver)` in the program's place."""

    class Controlled(driver_cls):
        def setup(self):
            self.program_class = lambda ctx, *a: control_cls(self)
            super().setup()

    return Controlled
