"""Percentiles of a run's frame times."""

import math


def p95(values):
    """The 95th percentile by nearest rank: the value below which at least
    95% of the samples lie."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
