"""Share of the traced slice with no kernel, copy or memset on the card,
in %."""

from benchmark.harness import layer


def read(run):
    return layer.idle_share(run)
