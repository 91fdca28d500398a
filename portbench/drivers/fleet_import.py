"""Bulk import of whole histories: ``Fleet(device).merge_text_payloads``.

A closed loop, one call after another, each of the mix's
``docs_per_call`` documents' full-history payloads; the run cycles over
the configuration's ``fleet_docs`` documents, made in set-up, every
payload of them distinct.  A step's ops
are the inserts and applied deletes of its documents, counted by the
generator.  Every text of every timed call is kept and, once the window
has closed, compared with the plain reference's.
"""
from __future__ import annotations

from typing import List

from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.parallel.fleet import Fleet
from portbench import traffic
from portbench.reference.fugue import TextReference


class FleetProgram:
    """The program: one fleet on the run's device."""

    def __init__(self, ctx):
        self.fleet = Fleet(device=ctx.device)
        self.cid = ContainerID.root(ctx.config["container"], ContainerType.Text)

    def merge(self, batch) -> List[str]:
        return self.fleet.merge_text_payloads([payload for _, payload in batch], self.cid).texts


class Driver:
    program_class = FleetProgram

    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.pool = traffic.load_pool(ctx.config, mix, ctx.cache_dir, ctx.log)
        n_docs, per_call = int(ctx.config["fleet_docs"]), int(mix["docs_per_call"])
        if n_docs % per_call:
            raise ValueError(f"{per_call} docs a call do not divide the fleet's {n_docs} docs")
        docs = traffic.make_docs(mix, self.pool, ctx.seed, n_docs)
        self.batches = [[(d, traffic.history_payload(self.pool, d)) for d in docs[i:i + per_call]]
                        for i in range(0, n_docs, per_call)]
        self.batch_ops = [sum(self.pool[d.base].ops for d, _ in b) for b in self.batches]
        self.results: List[tuple] = []  # (batch index, texts) of each timed call
        self.program = None

    def setup(self) -> None:
        self.program = self.program_class(self.ctx)
        self.program.merge(self.batches[0])  # warm: builds the codec, every shape of the cell

    def step(self) -> int:
        i = len(self.results) % len(self.batches)
        self.results.append((i, self.program.merge(self.batches[i])))
        return self.batch_ops[i]

    def finish(self) -> None:
        pass

    def release(self) -> None:
        self.program = None

    def check(self) -> dict:
        ref = TextReference([b.events for b in self.pool])
        wrong = docs = 0
        for i, texts in self.results:
            batch = self.batches[i]
            docs += len(batch)
            texts = list(texts)
            if len(texts) != len(batch):
                wrong += len(batch)
                continue
            for (d, _), got in zip(batch, texts):
                wrong += got != ref.text(d.base, d.peer_ids)
        limit = int(self.ctx.config["compare"]["wrong_texts"])
        return {"correct": wrong <= limit and docs > 0, "attempted": docs, "failed": wrong,
                "compared": {"wrong_texts": {"value": wrong, "limit": limit}}}
