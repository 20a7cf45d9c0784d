"""Median host time for ``eval/test_driver.py:reconstruct`` to return, the
batch already on the card."""


def read(r):
    return r.median_ms("step") if r.kind == "recon" else None
