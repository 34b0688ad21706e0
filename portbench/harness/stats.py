"""The benchmark's arithmetic, kept apart so that tests can hold it to
synthetic events and timings: percentiles, the device's busy time and
idle gaps, the roofline bound and the share of a peak.

The busy time follows `scripts/torch_port_profile.py`'s idle arithmetic
at commit 3f2e19a (one minus the union of kernel intervals over the
window), here with copies and fills counted and each interval clipped to
an explicit window, so that overlapping operations count once.
"""

# H100 SXM (NVIDIA's data sheet): HBM bandwidth
HBM_BYTES_PER_S = 3.35e12


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between ranks (as
    numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals, start: float, end: float) -> float:
    """Seconds of [start, end] covered by the union of (begin, end)
    intervals, each clipped to the window."""
    covered, reach = 0.0, start
    for b, e in sorted(intervals):
        b, e = max(b, reach), min(e, end)
        if e > b:
            covered += e - b
            reach = e
    return covered


def gaps(intervals, start: float, end: float):
    """[(begin, end)] of [start, end] that no interval covers, longest
    first."""
    out, reach = [], start
    for b, e in sorted(intervals):
        if b > reach:
            out.append((reach, min(b, end)))
        reach = max(reach, e)
        if reach >= end:
            break
    if reach < end:
        out.append((reach, end))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def bound_seconds(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time for the work on the chip: the larger of its bytes at
    the HBM bandwidth and its operations at the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def share_percent(flops_per_s: float, peak_flops: float) -> float:
    return 100.0 * flops_per_s / peak_flops
