"""The least time the stretch's work could take on the card (per model
layer, ``benchmark/work.py``) over its device busy time."""


def read(r):
    return r.roofline_percent("recon")
