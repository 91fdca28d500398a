"""Fleet merge front end, text family: a batch of documents merged in
one device call (the port of loro_tpu/parallel/fleet.py's one-shot text
merges, Fleet.merge_text_docs / merge_text_changes / merge_text_payloads).

Per call: every document's element table is padded to one bucketed row
count (pad_bucket), the doc axis to `pad_docs` with all-invalid filler
docs, the columns are written into one host array a column
(fugue_batch.stack_seq_columns) and uploaded (one copy a column),
materialize_content_batch merges the whole batch on the device, and one
fetch brings back the codes and counts.

The JAX Fleet is bound to a device mesh and pads the doc axis to a
multiple of its doc dimension; this one is bound to one device, where
that multiple is 1.  Not ported yet: the supervised launch and fetch
with its DeviceFailure -> host degradation (a CUDA error propagates as
it is), the obs counters and trace instants, and the other container
families.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..codec.binary import decode_changes
from ..core.change import Change
from ..core.ids import ContainerID
from ..device import DeviceLike, resolve_device
from ..ops.columnar import SeqExtract, extract_seq_container, extract_seq_from_payload
from ..ops.fugue_batch import materialize_content_batch, pad_bucket, seq_columns_to_torch, stack_seq_columns

# Payloads that the native explode rejected and the Python decode
# (decode_changes + extract_seq_container) was tried on, incremented
# where that fallback is taken: the counterpart of the JAX package's
# fleet.host_fallback_total{kind=payload_extract}.
FLEET_FALLBACKS: Dict[str, int] = {"payload_extract": 0}


@dataclass
class TextMergeResult:
    texts: List[str]


def texts_of(codes: np.ndarray, counts: np.ndarray, d: int) -> List[str]:
    """The first d docs' texts: the codepoints codes[i, :counts[i]], one
    UTF-32 decode a doc.  surrogatepass takes lone surrogates as chr
    does; a codepoint past U+10FFFF raises ValueError, as chr does."""
    return [codes[i, : int(counts[i])].astype("<u4").tobytes().decode("utf-32-le", "surrogatepass") for i in range(d)]


class Fleet:
    """Batched merge front end bound to one device (default "cuda";
    DeviceUnavailable without a card unless "cpu" is asked for)."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)

    def merge_text_docs(self, extracts: Sequence[SeqExtract], pad_docs: Optional[int] = None) -> TextMergeResult:
        """Final text of every document of the batch, merged in one
        device call.  Docs are padded to a common bucketed element count,
        the doc axis to `pad_docs` (default: the batch size)."""
        batched = stack_seq_columns(extracts, pad_bucket(max(e.n for e in extracts)), pad_docs)
        cols = seq_columns_to_torch(batched, device=self.device)
        codes, counts = materialize_content_batch(cols, device=self.device)
        return TextMergeResult(texts_of(codes.cpu().numpy(), counts.cpu().numpy(), len(extracts)))

    def merge_text_changes(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID) -> TextMergeResult:
        """Texts of container `cid` from each doc's decoded change list."""
        return self.merge_text_docs([extract_seq_container(chs, cid) for chs in docs_changes])

    def merge_text_payloads(self, payloads: Sequence[bytes], cid: ContainerID) -> TextMergeResult:
        """Texts of container `cid` from each doc's binary updates payload
        (envelope-stripped, full history): the native explode, and for a
        payload it rejects (ValueError, CodecDecodeError among them) the
        Python decode, counted in FLEET_FALLBACKS.  A payload whose
        inserts name elements outside it raises ValueError; a codec that
        cannot be built raises RuntimeError."""
        extracts = []
        for p in payloads:
            try:
                ex = extract_seq_from_payload(p, cid)
            except ValueError:
                FLEET_FALLBACKS["payload_extract"] += 1
                try:
                    ex = extract_seq_container(decode_changes(p), cid)
                except KeyError as e:
                    raise ValueError(
                        f"payload is not self-contained (references elements outside it: {e}); one-shot fleet "
                        "merges need full-history payloads"
                    ) from e
            extracts.append(ex)
        return self.merge_text_docs(extracts)
