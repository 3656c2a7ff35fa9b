"""capture_s (s, host clock): the first fused fit of set-up: the kernel
libraries loaded (built by nvcc in a checkout's first run) and the step's
CUDA graphs captured, then replayed for the fit's steps."""


def read(r):
    return r["spans"].get("capture_s")
