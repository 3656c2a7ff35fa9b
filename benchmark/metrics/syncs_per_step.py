"""syncs_per_step (count, program counter): the program's blocking spans
(sgv.probe from pageable memory, sgv.read, sgv.sync, sgv.exchange) in the
traced fits, a traced step."""

from benchmark import program_spans


def read(r):
    got = program_spans.spans(r)
    if got is None:
        return None
    return sum(1 for s in got if s["blocking"]) / r["trace"]["steps"]
