"""sync_idle_ms (ms, program spans): device-idle ms a traced step in the gaps
between device operations that began while the host was inside a blocking
span of the program (sgv.probe from pageable memory, sgv.read,
sgv.sync): the card drained because the program waited on it."""

from benchmark import program_spans


def read(r):
    split = program_spans.idle_split(r)
    return None if split is None else split["blocking"] / 1e6 / r["trace"]["steps"]
