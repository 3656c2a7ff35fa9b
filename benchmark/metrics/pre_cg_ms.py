"""pre_cg_ms (ms, program spans): device ms a traced step of the piece
sgv.piece.pre_cg: the denoiser, the LMMSE set-up, the preconditioner's
rebuild where there is one, and CG's first residual pass."""

from benchmark import program_spans


def read(r):
    return program_spans.piece_ms(r, "sgv.piece.pre_cg")
