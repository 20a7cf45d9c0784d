"""The model's operations (``benchmark/work.py``) over the window's wall time
at the card's peak, outside the traced stretch."""


def read(r):
    return r.mfu_percent("recon")
