"""Importer for the reference's PyTorch ``.pt`` checkpoints.

Port of ``geniconet_tpu/train/pt_import.py``. The reference ships trained
models as ``torch.save({'model_state_dict': ..., 'optimizer_state_dict':
..., 'epoch': N, 'loss': v, 'misc': ...})`` archives (reference
run.py:330-340), e.g. ``log/ae/savedModel/ico2ico_EB696.pt``. The file is
read by ``torch.load(path, map_location="cpu", weights_only=True)``: a
``.pt`` file is an arbitrary-code pickle, and ``weights_only`` resolves
only tensors, containers and numbers, so the file stays untrusted input.

``import_state_dict(sd, model_name)`` maps the reference's parameter names
(reference models.py:101-232: ``encoder.N``/``decoder.N`` Sequential
indices, block-internal ``conv00``/``icobn00``/..., ``mu.0``/``logvar.0``,
``enc2icoConv.0``/``final_layer.0``) onto the flax tree of the JAX package
(``encoder/conv_in``, ``encoder/down{k}/conv00``, ``decoder/up{k}``,
``mu_conv``, ``decoder/head``, ...), which the port's models, ``bridge``
and ``.ckpt`` files use, converting each leaf:

* ico conv weights -> the (7, Cin, Cout) ``taps``. The layout is
  shape-sniffed: an OIHW ``(O, I, 3, 3)`` masked kernel goes through
  ``ops.conv.kernel_to_taps`` (its corner taps must be zero and are
  dropped); an ``(O, I, 7)``-class layout is transposed to ``(7, I, O)``;
  then the optional ``tap_order`` permutation (identity: the row-major
  stencil order of ``ops/conv.py:HEX_TAP_OFFSETS``).
* ``BatchNorm2d``: ``weight``/``bias`` -> ``scale``/``bias`` params,
  ``running_mean``/``running_var`` -> batch_stats ``mean``/``var``
  (``num_batches_tracked`` is dropped).
* The 1x1 head ``Conv2d``: OIHW ``(3, 64, 1, 1)`` -> dense ``kernel`` ``(64, 3)``.

As the reference's own ``loadModel`` (run.py:357-367), only keys that map
onto the target tree are taken; the rest (the conv modules' index buffers,
say) are reported as skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from geniconet_tpu_torch.ops.conv import kernel_to_taps

__all__ = ["import_state_dict", "load_reference_checkpoint"]

# block-internal names, shared by the Down and Up blocks
# (reference models.py:22-63 -> nn/models.py DownBlock/UpBlock)
_BLOCK_LEAVES = {
    "conv00": ("conv00", "conv"),
    "conv01": ("conv01", "conv"),
    "conv10": ("conv10", "conv"),
    "icobn00": ("bn00", "bn"),
    "icobn01": ("bn01", "bn"),
    "icobn10": ("bn10", "bn"),
}


def _model_map(model_name: str) -> dict:
    """torch Sequential prefix -> (flax path tuple, kind); kind: 'conv' (ico
    conv -> taps/bias), 'bn' (BatchNorm2d), 'head' (1x1 Conv2d -> dense
    kernel), 'block' (expands to ``_BLOCK_LEAVES``)."""
    if model_name in ("ico2ico", "ico2enc", "enc2ico"):
        return {
            "encoder.0": (("encoder", "conv_in"), "conv"),
            "encoder.1": (("encoder", "bn_in"), "bn"),
            "encoder.3": (("encoder", "down0"), "block"),
            "encoder.4": (("encoder", "down1"), "block"),
            "encoder.5": (("encoder", "down2"), "block"),
            "decoder.0": (("decoder", "up0"), "block"),
            "decoder.1": (("decoder", "up1"), "block"),
            "decoder.2": (("decoder", "up2"), "block"),
            "enc2icoConv.0": (("decoder", "head"), "head"),
        }
    if model_name in ("ico2ico_vae", "ico2enc_vae", "enc2ico_vae"):
        return {
            "encoder.0": (("encoder", "conv_in"), "conv"),
            "encoder.1": (("encoder", "bn_in"), "bn"),
            "encoder.3": (("encoder", "down0"), "block"),
            "encoder.4": (("encoder", "down1"), "block"),
            "mu.0": (("mu_conv",), "conv"),
            "mu.1": (("mu_bn",), "bn"),
            "logvar.0": (("logvar_conv",), "conv"),
            "logvar.1": (("logvar_bn",), "bn"),
            "decoder.0": (("decoder", "up0"), "block"),
            "decoder.1": (("decoder", "up1"), "block"),
            "decoder.2": (("decoder", "up2"), "block"),
            "final_layer.0": (("decoder", "head"), "head"),
        }
    raise ValueError(f"no reference key map for model {model_name!r}")


def _numpy(value) -> np.ndarray:
    """A state-dict entry as numpy (bfloat16 and half tensors widened to float32)."""
    if torch.is_tensor(value):
        value = value.detach().cpu()
        if value.is_floating_point() and value.dtype != torch.float64:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _numpy_tree(x):
    """``misc`` with every tensor as numpy, as the JAX package's reader returns it."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return _numpy(x) if torch.is_tensor(x) else x


def _weight_to_taps(w: np.ndarray, tap_order) -> np.ndarray:
    """Shape-sniff an ico-conv weight into the (7, Cin, Cout) taps param."""
    w = np.asarray(w)
    if w.ndim == 4 and w.shape[2:] == (3, 3):
        # OIHW masked 3x3 kernel: corners must carry no weight
        corners = np.abs(w[:, :, [0, 2], [0, 2]]).max() if w.size else 0.0
        if corners > 1e-6 * max(np.abs(w).max(), 1.0):
            raise ValueError("3x3 ico-conv weight has non-zero corner taps — not a "
                             "hexagonal stencil")
        taps = kernel_to_taps(np.transpose(w, (2, 3, 1, 0)))  # -> HWIO
    elif w.ndim == 4 and 7 in w.shape[2:] and 1 in w.shape[2:]:
        taps = np.transpose(w.reshape(w.shape[0], w.shape[1], 7), (2, 1, 0))
    elif w.ndim == 3 and w.shape[2] == 7:
        taps = np.transpose(w, (2, 1, 0))  # (O, I, 7) -> (7, I, O)
    else:
        raise ValueError(f"unrecognized ico-conv weight shape {w.shape}")
    if tap_order is not None:
        taps = taps[np.asarray(tap_order)]
    return np.ascontiguousarray(taps.astype(np.float32))


def _set(tree: dict, path: tuple, value: np.ndarray):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def import_state_dict(sd: dict, model_name: str = "ico2ico",
                      tap_order=None) -> tuple[dict, dict, list]:
    """Map a reference state dict (tensors or arrays) onto (params,
    batch_stats) numpy trees. ``tap_order``: an optional permutation of the
    7 taps, for a stencil order other than ``HEX_TAP_OFFSETS`` (identity by
    default; the reference's real order can only be derived from its real
    weights). Returns ``(params, batch_stats, skipped_keys)``; the skipped
    keys are buffers and unknown entries (reference run.py:364: "Selected %d
    dict keys out of %d keys")."""
    modmap: dict[str, tuple[tuple, str]] = {}
    for pref, (path, kind) in _model_map(model_name).items():
        if kind == "block":
            for tname, (fname, k) in _BLOCK_LEAVES.items():
                modmap[f"{pref}.{tname}"] = (path + (fname,), k)
        else:
            modmap[pref] = (path, kind)

    # group the keys by their owning torch module
    by_mod: dict[str, dict[str, np.ndarray]] = {}
    skipped = []
    for key, val in sd.items():
        mod, _, leaf = key.rpartition(".")
        if mod in modmap:
            by_mod.setdefault(mod, {})[leaf] = _numpy(val)
        else:
            skipped.append(key)

    params: dict = {}
    stats: dict = {}
    for mod, leaves in by_mod.items():
        path, kind = modmap[mod]
        if kind == "conv":
            _set(params, path + ("taps",), _weight_to_taps(leaves["weight"], tap_order))
            if "bias" in leaves:
                _set(params, path + ("bias",), leaves["bias"].astype(np.float32))
            # registered buffers (icocnn pad/index tables) are not params
            skipped.extend(f"{mod}.{x}" for x in leaves if x not in ("weight", "bias"))
        elif kind == "bn":
            bnp = path + ("BatchNorm_0",)
            _set(params, bnp + ("scale",), leaves["weight"].astype(np.float32))
            _set(params, bnp + ("bias",), leaves["bias"].astype(np.float32))
            _set(stats, bnp + ("mean",), leaves["running_mean"].astype(np.float32))
            _set(stats, bnp + ("var",), leaves["running_var"].astype(np.float32))
            skipped.extend(f"{mod}.{x}" for x in leaves
                           if x not in ("weight", "bias", "running_mean", "running_var"))
        else:  # head
            w = leaves["weight"]  # OIHW (3, 64, 1, 1)
            if w.ndim != 4 or w.shape[2:] != (1, 1):
                raise ValueError(f"head conv weight shape {w.shape}")
            _set(params, path + ("kernel",),
                 np.ascontiguousarray(w[:, :, 0, 0].T.astype(np.float32)))
            _set(params, path + ("bias",), leaves["bias"].astype(np.float32))
            skipped.extend(f"{mod}.{x}" for x in leaves if x not in ("weight", "bias"))
    return params, stats, skipped


def load_reference_checkpoint(path: str, model_name: str = "ico2ico", tap_order=None) -> dict:
    """A ``.pt`` file -> ``{"params", "batch_stats", "epoch", "loss", "misc",
    "skipped_keys"}`` (the layout of ``train/checkpoint.py``'s trees)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    params, stats, skipped = import_state_dict(sd, model_name, tap_order)
    n_total = len(sd)
    n_mapped = n_total - len(skipped)
    print(f"[pt_import] mapped {n_mapped}/{n_total} reference keys onto the {model_name} tree"
          + (f"; skipped buffers/unknown: {sorted(skipped)[:6]}..." if skipped else ""))
    # a file whose keys carry a prefix (torch DataParallel's 'module.') maps
    # nothing: fail here, not later at a shape error
    if not params or n_mapped == 0:
        raise ValueError(f"no reference parameters mapped from {path!r} (model {model_name}); "
                         f"first keys: {sorted(sd)[:4]} — if they carry a prefix (e.g. "
                         "'module.'), strip it before importing")
    loss = ckpt.get("loss")
    return {
        "params": params,
        "batch_stats": stats,
        "epoch": int(ckpt.get("epoch", 0)),
        "loss": None if loss is None else float(loss),
        "misc": _numpy_tree(ckpt.get("misc")),
        "skipped_keys": skipped,
    }
