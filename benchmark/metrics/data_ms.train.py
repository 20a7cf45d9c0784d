"""Median host time inside Batches.epoch() per batch: the shuffle's index
slice, its copy to the card and the gather's launch."""


def read(r):
    return r.median_ms("data") if r.kind == "train" else None
