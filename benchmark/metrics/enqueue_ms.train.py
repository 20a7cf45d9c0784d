"""Median host time a training step takes between train_epoch receiving its
batch and asking for the next (the wrapper, autograd and launch path; every
log_freq-th step also waits for the device)."""


def read(r):
    return r.median_ms("step") if r.kind == "train" else None
