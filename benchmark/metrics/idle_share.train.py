"""Percent of the traced round in which nothing ran on the device."""

from benchmark import readings


def read(run):
    return readings.idle_share(run)
