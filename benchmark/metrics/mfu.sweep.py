"""The served forward's share of the card's peak, in %: the query
U-Net's convolution FLOPs of the slice's frames (the baked pyramid
stands in for the observation net) over its window at the compute
dtype's dense peak."""

from benchmark.harness import layer


def read(run):
    return layer.mfu(run, ("query",), 1)
