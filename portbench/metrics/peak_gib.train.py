"""peak_gib.train: The allocator's peak over the unprofiled stretch of train steps
(max_memory_allocated after reset_peak_memory_stats)."""

from harness.readers import peak_gib

UNIT = "GiB"


def read(r):
    return peak_gib(r, 'train')
