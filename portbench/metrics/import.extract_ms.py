"""import.extract_ms: host ms a merge call in the payload codec, the
native explode of each payload (``ops/columnar.extract_seq_from_payload``
-> ``native/seq_codec.cpp``), wrapped where ``parallel/fleet`` looks it up."""

TARGET = "loro_tpu_torch.parallel.fleet:extract_seq_from_payload"
WRAPS = [{"target": TARGET}]


def read(probe):
    return probe.ms_per_step(TARGET)
