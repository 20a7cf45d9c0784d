"""Checkpoints in the JAX package's own ``.ckpt`` format: naming, GC, partial loads.

Port of ``geniconet_tpu/train/checkpoint.py``. A file holds one tree
``{params, batch_stats, opt_state, step, epoch, loss, best_loss[, misc]}``
serialised as flax's ``msgpack_serialize`` writes it, so a file written by
either package restores in the other:

* best checkpoints are ``<model>_EB<epoch>.ckpt`` and only the newest 6 are
  kept (``gc_best_checkpoints``, reference run.py:317-328); periodic ones
  are ``<model>_E<epoch>.ckpt``;
* ``latest_best_epoch`` is the newest EB epoch (reference run.py:343-349),
  ``latest_checkpoint`` the newest file of either kind (at equal epoch the
  periodic one, written after the EB);
* ``restore_filtered`` / ``merge_checkpoints`` load the intersection of a
  stored and a target tree (reference run.py:360-409).

The codec is written here in Python with ``struct`` (the card's machine has
neither flax nor msgpack): msgpack's nil, bool, int, float, str, bin, array
and map, and flax's extension types 1 (an ndarray: a msgpack
``(shape, dtype name, C-order bytes)``) and 3 (a numpy scalar, the same
payload). Dicts are written with sorted keys and ints in their shortest
form, as flax writes them, so the bytes equal flax's for the same tree.
Arrays read as read-only numpy views of the file's bytes; a ``bfloat16``
array (which numpy cannot hold) reads widened to float32, exactly. Two forms
raise: an orbax checkpoint directory (the JAX package's
``GENICONET_CKPT_BACKEND=orbax``) and flax's chunked form of an array over
2^30 bytes.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

__all__ = [
    "serialize",
    "deserialize",
    "save_checkpoint",
    "load_checkpoint",
    "latest_best_epoch",
    "latest_checkpoint",
    "available_epochs",
    "checkpoint_path",
    "gc_best_checkpoints",
    "restore_filtered",
    "merge_checkpoints",
]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_ARRAY_BYTES = 2**30  # flax chunks larger arrays (serialization.MAX_CHUNK_SIZE)
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# msgpack writer
# ----------------------------------------------------------------------

_UINTS = ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64))
_INTS = ((0xD0, ">b", -(2**7)), (0xD1, ">h", -(2**15)), (0xD2, ">i", -(2**31)),
         (0xD3, ">q", -(2**63)))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(v: int, out: list):
    if -32 <= v < 0x80:
        out.append(struct.pack("b" if v < 0 else "B", v))
        return
    for code, fmt, bound in (_UINTS if v >= 0 else _INTS):
        if (v < bound) if v >= 0 else (v >= bound):
            out.append(struct.pack(">B", code) + struct.pack(fmt, v))
            return
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int | None, fixmax: int, codes: tuple, out: list):
    """The header of a str, bin, array or map of ``n`` bytes or items:
    ``fix | n`` up to ``fixmax``, else the first of ``codes`` (8, 16 and
    32-bit lengths; None where the type has no such form) that holds n."""
    if fix is not None and n <= fixmax:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 2 ** (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of {n} bytes or items")


def _pack_ext(code: int, n: int, out: list):
    """The header of an extension object of type ``code`` and ``n`` bytes."""
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
        return
    for head, fmt in ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")):
        if n < 2 ** (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B", head) + struct.pack(fmt, n) + struct.pack(">b", code))
            return
    raise ValueError(f"msgpack extension of {n} bytes")


def _pack_ndarray(code: int, a: np.ndarray, out: list):
    """flax's extension: a msgpack (shape, dtype name, C-order bytes), the
    bytes appended as a view of the array (no copy)."""
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialise an array of dtype {a.dtype}")
    if a.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes: flax chunks arrays over 2^30 bytes, "
                         "a form this codec does not write")
    head = [b"\x93"]  # a fixarray of 3
    _pack([int(d) for d in a.shape], head)
    _pack(a.dtype.name, head)
    _pack_len(a.nbytes, None, 0, (0xC4, 0xC5, 0xC6), head)
    data = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    _pack_ext(code, sum(map(len, head)) + a.nbytes, out)
    out.extend(head)
    out.append(data)


def _pack(x, out: list):
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(x) is bytes:
        _pack_len(len(x), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(x)
    elif type(x) in (list, tuple):
        _pack_len(len(x), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k in sorted(x):
            _pack(k, out)
            _pack(x[k], out)
    elif isinstance(x, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, x, out)
    elif isinstance(x, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(x), out)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__} (convert tensors to numpy first)")


def serialize(tree) -> bytes:
    """A tree of dicts (str keys), lists, python scalars, numpy arrays and
    numpy scalars -> msgpack bytes, as ``flax.serialization.msgpack_serialize``
    writes the same tree."""
    out = []
    _pack(tree, out)
    return b"".join(out)


# ----------------------------------------------------------------------
# msgpack reader
# ----------------------------------------------------------------------

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (length format, kind) of the sized types
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"),
          0xDF: (">I", "map")}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


class _Reader:
    """Reads one msgpack object from ``data``; ``views`` returns bin objects
    as views of ``data`` instead of copies (an array's bytes)."""

    def __init__(self, data, views: bool = False):
        self.buf, self.pos, self.views = memoryview(data), 0, views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n : self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def sized(self, kind: str, n: int):
        if kind == "bin":
            return self.take(n) if self.views else bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                k = self.read()
                out[k] = self.read()
            return out
        code = self.unpack(">b")
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an array or a numpy scalar")
        a = _ndarray_from_payload(self.take(n))
        return a if code == _EXT_NDARRAY else a[()]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.sized("map", b & 0x0F)
        if b <= 0x9F:
            return self.sized("array", b & 0x0F)
        if b <= 0xBF:
            return self.sized("str", b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT_LEN:
            return self.sized("ext", _FIXEXT_LEN[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not one this codec reads")
        fmt, kind = _SIZED[b]
        return self.sized(kind, self.unpack(fmt))


def _ndarray_from_payload(payload) -> np.ndarray:
    shape, name, data = _Reader(payload, views=True).read()
    if name == "bfloat16":  # the top 16 bits of a float32
        wide = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _reject_chunked(tree, path="checkpoint"):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(f"{path}: flax's chunked array form (an array over 2^30 bytes) "
                             "is not read by this codec")
        for k, v in tree.items():
            _reject_chunked(v, f"{path}/{k}")


def deserialize(data) -> dict:
    """msgpack bytes as flax writes them -> the tree
    (``flax.serialization.msgpack_restore``'s result)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    _reject_chunked(tree)
    return tree


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------


def _best_epochs(ckpt_dir: str, model_name: str) -> list:
    """Epoch numbers of this model's EB checkpoints. The filename is matched
    exactly (``<model>_EB<n>.ckpt``), so model 'ico2ico' never picks up
    'ico2ico_vae_EB3.ckpt' when two models share a directory."""
    pat = re.compile(re.escape(model_name) + r"_EB(\d+)\.ckpt")
    return [int(m.group(1)) for m in map(pat.fullmatch, os.listdir(ckpt_dir)) if m]


def checkpoint_path(ckpt_dir: str, model_name: str, epoch: int, best: bool) -> str:
    tag = "EB" if best else "E"
    return os.path.join(ckpt_dir, f"{model_name}_{tag}{epoch}.ckpt")


def save_checkpoint(path: str, state: dict):
    """Write ``state`` (a tree of numpy arrays and python scalars) to
    ``path`` through a temporary file and ``os.replace``, so a reader never
    sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = serialize(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory (the JAX package's "
                         "GENICONET_CKPT_BACKEND=orbax); the port reads the msgpack .ckpt "
                         "files only")
    with open(path, "rb") as f:
        return deserialize(f.read())


def latest_best_epoch(ckpt_dir: str, model_name: str):
    """Newest EB epoch number or None (reference run.py:343-349)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = _best_epochs(ckpt_dir, model_name)
    return max(best) if best else None


def _checkpoints(ckpt_dir: str, model_name: str):
    """(epoch, is periodic, file name) of each of this model's checkpoints."""
    pat = re.compile(re.escape(model_name) + r"_(EB?)(\d+)\.ckpt")
    return [(int(m.group(2)), m.group(1) == "E", m.group(0))
            for m in map(pat.fullmatch, os.listdir(ckpt_dir)) if m]


def available_epochs(ckpt_dir: str, model_name: str) -> dict:
    """All restorable epochs, ``{"best": [...], "periodic": [...]}`` sorted
    ascending (the explorer's epoch list, reference app.py:54-96)."""
    out = {"best": [], "periodic": []}
    if os.path.isdir(ckpt_dir):
        for epoch, periodic, _ in _checkpoints(ckpt_dir, model_name):
            out["periodic" if periodic else "best"].append(epoch)
    out["best"].sort()
    out["periodic"].sort()
    return out


def latest_checkpoint(ckpt_dir: str, model_name: str):
    """Path of the newest checkpoint of either kind, the higher epoch first
    and at equal epoch the periodic save (the EB was written before it)."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = _checkpoints(ckpt_dir, model_name)
    return os.path.join(ckpt_dir, max(cands)[2]) if cands else None


def gc_best_checkpoints(ckpt_dir: str, model_name: str, keep: int = 6):
    """Keep the newest ``keep`` EB checkpoints. Called after saving a new
    best, this is the reference's rule (run.py:317-328: delete all but the
    newest 5 existing EB files, then save the new one)."""
    if not os.path.isdir(ckpt_dir):
        return
    for e in sorted(_best_epochs(ckpt_dir, model_name))[:-keep]:
        try:
            os.remove(checkpoint_path(ckpt_dir, model_name, e, best=True))
        except FileNotFoundError:
            pass


def restore_filtered(target_tree, stored_tree):
    """Copy stored leaves into ``target_tree`` (nested dicts of arrays) where
    the path and shape match, cast to the target's dtype. Returns
    ``(merged_tree, n_matched, n_target_leaves)`` (reference run.py:360-367:
    an encoder or decoder half restored from a whole model's checkpoint)."""
    matched = n_leaves = 0

    def merge(tgt, stored):
        nonlocal matched, n_leaves
        if isinstance(tgt, dict):
            return {k: merge(v, stored.get(str(k)) if isinstance(stored, dict) else None)
                    for k, v in tgt.items()}
        n_leaves += 1
        if hasattr(stored, "shape") and tuple(stored.shape) == tuple(np.shape(tgt)):
            matched += 1
            return np.asarray(stored).astype(tgt.dtype) if hasattr(tgt, "dtype") else stored
        return tgt

    merged = merge(target_tree, stored_tree)
    return merged, matched, n_leaves


def merge_checkpoints(target_tree, paths):
    """Merge the param trees of several checkpoints into one target
    (reference ``loadMultiModel``, run.py:383-409). Later paths win on
    overlapping keys; returns ``(merged, total_matched, n_target_leaves)``."""
    merged, total = target_tree, 0
    for p in paths:
        blob = load_checkpoint(p)
        merged, matched, _ = restore_filtered(merged, blob.get("params", blob))
        total += matched
    return merged, total, restore_filtered(target_tree, {})[2]
