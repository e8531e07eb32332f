"""Device busy ms a unit (training step or request) in the traced slice:
the union of kernels, copies and memsets on the card's timeline."""

from benchmark.harness import layer


def read(run):
    return layer.device_ms_per_unit(run)
