"""1 - the device's busy time a batch (the traced stretch's, union of its
device events) / the wall time a batch of the same window outside the stretch."""


def read(r):
    return r.idle_percent("recon")
