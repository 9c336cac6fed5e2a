"""The device's idle share of the traced GAR fit, in %: 1 - (the union of
its activity intervals / the segment's length), read as
`dev.idle_share.fit` reads it."""

from portbench import harness


def read(run):
    return harness.metric_reader("dev.idle_share.fit").read(run)
