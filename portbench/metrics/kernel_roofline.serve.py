"""kernel_roofline.serve: The port's kernels on serving's path: their operations' bound (bytes from
shapes at the HBM bandwidth) over their profiled device time."""

from harness.readers import kernel_roofline

UNIT = "%"


def read(r):
    return kernel_roofline(r, 'serve')
