"""setup_s (s, host clock): process start to the window's start: the
panel made from the seed, the port's ingestion, the engine, and the warm-up
fits (in a checkout's first run also the kernels' nvcc build)."""


def read(r):
    return r["setup_s"]
