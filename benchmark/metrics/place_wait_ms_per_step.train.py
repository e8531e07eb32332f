"""Host ms a training step waits on the card during placement: the
program's ``feat_cache.indices`` spans in the traced slice (the statics
cache's slot indices uploaded from pageable memory, a copy that waits
for the work queued before it) over the slice's steps."""

from benchmark.harness import program

SPAN = "feat_cache.indices"


def read(run):
    return program.ms_per_unit(run, SPAN)
