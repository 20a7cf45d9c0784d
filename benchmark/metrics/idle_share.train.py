"""1 - the device's busy time a step (the traced stretch's, union of its
device events) / the wall time a step of the same window outside the stretch."""


def read(r):
    return r.idle_percent("train")
