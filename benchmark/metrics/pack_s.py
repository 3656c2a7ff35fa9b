"""pack_s (s, host clock): the port's ingestion, SymBandedLD.from_band over
the band on the host: the int8 packer and the copy of every cohort's blocks
to the card."""


def read(r):
    return r["spans"].get("pack_s")
