"""The training step's share of the card's peak, in %: the U-Net's
convolution FLOPs (both nets; forward once, backward twice; the loss
networks and nothing recomputed not counted) of the slice's steps over
its window at the compute dtype's dense peak."""

from benchmark.harness import layer


def read(run):
    return layer.mfu(run, ("query", "obs"), 3)
