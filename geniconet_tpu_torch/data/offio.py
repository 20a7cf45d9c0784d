"""OFF mesh files: ``read_off`` and ``write_off``.

Port of those two functions of ``geniconet_tpu/data/offio.py`` (the
behaviour of the reference's ``python_utils.read_off`` / ``writeOffMesh``:
reference generate.py:167, ico_utils.py:32, app.py:1276), in numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_off", "write_off"]


def read_off(path: str):
    """-> (vertices (V, 3) float32, faces (F, 3) int64)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    i = 0
    if tokens[0].upper().startswith("OFF"):
        # handle both "OFF\n" and "OFF<counts on same line>"
        if tokens[0].upper() == "OFF":
            i = 1
        else:
            tokens[0] = tokens[0][3:]
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    vals = np.asarray(tokens[i : i + 3 * nv], dtype=np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        if k != 3:
            raise ValueError(f"{path}: only triangle faces supported, got {k}-gon")
        faces.append((int(tokens[i + 1]), int(tokens[i + 2]), int(tokens[i + 3])))
        i += k + 1
    return vals, np.asarray(faces, dtype=np.int64)


def write_off(path: str, vertices, faces):
    """Write a triangle mesh as OFF."""
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as out:
        out.write("OFF\n")
        out.write(f"{len(v)} {len(f)} 0\n")
        np.savetxt(out, v, fmt="%.8g")
        np.savetxt(
            out,
            np.concatenate([np.full((len(f), 1), 3, np.int64), f], axis=1),
            fmt="%d",
        )
