"""post_cg_ms (ms, program spans): device ms a traced step of the piece
sgv.piece.post_cg: damping, Hutchinson, the precision recursions, the
gamw pass and the state's update."""

from benchmark import program_spans


def read(r):
    return program_spans.piece_ms(r, "sgv.piece.post_cg")
