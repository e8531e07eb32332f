"""Host ms a training step spends in the compiled program's call: the
program's ``graph.call`` spans in the traced slice (the graph key, the
copy of the inputs into the graph's buffers, the replay's launch, the
outputs' clones) over the slice's steps."""

from benchmark.harness import program

SPAN = "graph.call"


def read(run):
    return program.ms_per_unit(run, SPAN)
