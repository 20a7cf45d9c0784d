"""Mesh files: ``read_off``, ``write_off`` and ``read_ply``.

Port of ``geniconet_tpu/data/offio.py`` (the behaviour of the reference's
``python_utils.read_off`` / ``writeOffMesh``: reference generate.py:167,
ico_utils.py:32, app.py:1276; ``read_ply`` the subset of plyfile the
reference's file viewer reads), in numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_off", "write_off", "read_ply"]


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


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Minimal stdlib .ply triangle-mesh reader -> (vertices (V,3) float32,
    faces (F,3) int64). Supports ascii and binary_little_endian with
    x/y/z vertex properties (extra properties skipped) and a face
    vertex_indices/vertex_index list — the subset the reference's generic
    file viewer reads via plyfile (reference app.py:1271-1274, 1545)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_dtype|('list', cnt_dt, val_dt), prop_name)])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(
                        (("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]]),
                         parts[4]))
                else:
                    elements[-1][2].append((_PLY_DTYPES[parts[1]], parts[2]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        verts, faces = None, None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
            if name == "vertex":
                idx = {p: k for k, (_, p) in enumerate(props)}
                if not {"x", "y", "z"} <= set(idx):
                    raise ValueError(f"{path}: vertex element lacks x/y/z")
                if fmt == "ascii":
                    arr = np.asarray(rows, dtype=np.float32)
                    verts = arr[:, [idx["x"], idx["y"], idx["z"]]]
                else:
                    dt = np.dtype([(p, "<" + d) for (d, p) in props])
                    rec = np.frombuffer(f.read(dt.itemsize * count), dt)
                    verts = np.stack(
                        [rec["x"], rec["y"], rec["z"]], 1).astype(np.float32)
            elif name == "face":
                out = []
                if fmt == "ascii":
                    for r in rows:
                        k = int(r[0])
                        if k != 3:
                            raise ValueError(
                                f"{path}: only triangle faces supported, got {k}-gon")
                        out.append([int(r[1]), int(r[2]), int(r[3])])
                else:
                    (kind, cnt_dt, val_dt), _ = props[0]
                    if kind != "list":
                        raise ValueError(f"{path}: face element without a vertex list")
                    cnt_dt, val_dt = np.dtype("<" + cnt_dt), np.dtype("<" + val_dt)
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                        vals = np.frombuffer(f.read(val_dt.itemsize * k), val_dt)
                        if k != 3:
                            raise ValueError(
                                f"{path}: only triangle faces supported, got {k}-gon")
                        out.append(vals)
                faces = np.asarray(out, dtype=np.int64)
            else:  # skip unknown elements (ascii rows already consumed)
                if fmt != "ascii":
                    fixed = [p for p in props if not isinstance(p[0], tuple)]
                    if len(fixed) != len(props):
                        raise ValueError(
                            f"{path}: cannot skip binary list element {name!r}")
                    size = sum(np.dtype(d).itemsize for d, _ in fixed)
                    f.read(size * count)
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int64)
    return verts, faces
