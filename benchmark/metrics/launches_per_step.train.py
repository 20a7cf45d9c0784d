"""Kernel launches per training step through the program's wrappers
(``ops/kernels/build.py:LAUNCHES``)."""


def read(r):
    if r.kind != "train" or not r.launch_steps:
        return None
    return r.launches / r.launch_steps
