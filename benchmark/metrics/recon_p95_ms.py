"""The 95th percentile of a batch's latency, from taking its grids off the
host to holding its vertices on the host, over the window's batches outside
the traced stretch."""

import numpy as np


def read(r):
    values = r.host_ms.get("batch") if r.kind == "recon" else None
    return float(np.percentile(values, 95)) if values else None
