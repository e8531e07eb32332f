"""Host ms a request spends placing its inputs on the card: the
program's ``serve.place`` spans in the traced slice (the input cache's
assembly or the upload) over the slice's requests."""

from benchmark.harness import program

SPAN = "serve.place"


def read(run):
    return program.ms_per_unit(run, SPAN)
