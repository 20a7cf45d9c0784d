"""Share of the device's busy time in the traced stretch spent in kernels
the program's kernel library did not build (PyTorch's elementwise, reduction,
copy and optimizer kernels) and in memsets."""


def read(r):
    return r.glue_percent("recon")
