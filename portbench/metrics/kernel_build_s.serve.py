"""kernel_build_s.serve: Host seconds of the program's `nvcc` runs in set-up:
its set-up record's `kernel_build.*` phases (utils/trace.py's SETUP); 0 where
the kernel libraries were built by an earlier run in the checkout."""

from harness.spans import kernel_build_s

UNIT = "s"


def read(r):
    return kernel_build_s(r, 'serve')
