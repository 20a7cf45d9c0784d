"""Device time of a batch's copies between host and card (its grids in,
its vertices out), from the traced stretch."""


def read(r):
    if not r.traced("recon") or not r.stretch_units:
        return None
    copies = sum(e["dur"] for e in r.stretch.events if e["cat"] == "gpu_memcpy")
    return copies / 1e3 / r.stretch_units
