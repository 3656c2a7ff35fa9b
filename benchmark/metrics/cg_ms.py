"""cg_ms (ms, program spans): device ms a traced step of the piece sgv.piece.cg:
CG's iterations (100 LD passes under the forced budget), their lane casts
and CG's vector work."""

from benchmark import program_spans


def read(r):
    return program_spans.piece_ms(r, "sgv.piece.cg")
