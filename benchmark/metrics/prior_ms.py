"""prior_ms (ms, program spans): device ms a traced step of the piece
sgv.piece.prior, the prior update (em_init and the EM chunks here), from
the event before its first replay to the event after its last: the idle
card at the host reads between its chunks counts in it."""

from benchmark import program_spans


def read(r):
    return program_spans.piece_ms(r, "sgv.piece.prior")
