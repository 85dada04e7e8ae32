"""setup_s: seconds from the run's start to the end of the warm-up:
Python and torch, the CUDA context, the kernel library (nvcc on a
checkout's first run), the artifacts, every shape warmed on memories of
its own."""


def read(win):
    return win.setup_s
