"""Device ms of host-to-device copies a request in the traced slice."""

COPIES = ("HtoD",)


def read(run):
    sl = run.slice
    if sl is None or not sl.units:
        return None
    spent = sl.summed(cats=("gpu_memcpy",), match=COPIES)
    return spent / sl.units * 1e3 if spent > 0 else None
