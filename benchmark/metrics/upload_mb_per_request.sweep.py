"""MiB a request uploads from the host: the program's count of uploaded
bytes (``upload.bytes``) over the traced slice, per request."""

from benchmark.harness import program


def read(run):
    n = program.counted(run, "upload.bytes")
    if n is None or not run.slice.units:
        return None
    return n / run.slice.units / float(1 << 20)
