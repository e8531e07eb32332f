"""Host ms a request spends staging its fields from pageable into pinned
memory: the program's ``upload.pin`` spans in the traced slice over the
slice's requests."""

from benchmark.harness import program

SPAN = "upload.pin"


def read(run):
    return program.ms_per_unit(run, SPAN)
