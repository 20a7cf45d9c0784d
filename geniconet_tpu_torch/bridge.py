"""Weight bridge between the flax variable tree and the port's state_dict.

The flax tree of ``geniconet_tpu.nn.models.IcoAE`` or ``IcoVAE`` (the same
on the XLA and fused routes) is ``{"params": ..., "batch_stats": ...}`` as nested dicts;
the port's module tree mirrors it, so the mapping is by path:

  params/<path>/{taps,bias}                  <-> <path>.{taps,bias}
  params/<path>/BatchNorm_0/{scale,bias}     <-> <path>.{scale,bias}
  batch_stats/<path>/BatchNorm_0/{mean,var}  <-> <path>.{mean,var}
  params/decoder/head/{kernel,bias}          <-> decoder.head.{kernel,bias}
  params/W                                   <-> W  (the debug IcoIdentity)

A BatchNorm is the module named ``bn*`` (the blocks' ``bn00``, ``bn_in``)
or ``*_bn`` (the VAE's ``mu_bn``, ``logvar_bn``). ``init_variables`` builds
such a tree in numpy from a seed, in the JAX package's init recipe, so
weights can be made without JAX.

Adam's state maps the same way (``adam_state_to_flax``,
``adam_state_from_flax``): ``optax.adam(learning_rate=schedule)`` flattens
(``flax.serialization.to_state_dict``) to ``{"0": {"count", "mu", "nu"},
"1": {"count"}}`` (``scale_by_adam``'s state, then the schedule's), ``mu`` and
``nu`` in the params' layout; they are ``torch.optim.Adam``'s ``exp_avg`` and
``exp_avg_sq``, and both counts its ``step``. The two update rules are the
same formula (bias-corrected moments, eps outside the square root).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax", "flax_path", "flatten_tree",
           "init_variables", "adam_state_to_flax", "adam_state_from_flax"]

_BN = "BatchNorm_0"


def _is_bn(module_name: str) -> bool:
    return module_name.startswith("bn") or module_name.endswith("_bn")


def flatten_tree(tree, prefix=()):
    """(path of keys, leaf) of a tree of nested dicts, keys sorted at every
    level: the order in which ``jax.tree`` flattens a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree (nested dicts of arrays) -> state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_tree(variables.get(collection, {})):
            key = ".".join(p for p in path if p != _BN)
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            out[key] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def flax_path(key: str) -> tuple:
    """A state_dict key -> (flax collection, path of keys in it)."""
    *mods, leaf = key.split(".")
    is_bn = bool(mods) and _is_bn(mods[-1])
    collection = "batch_stats" if leaf in ("mean", "var") else "params"
    return collection, (*mods, *([_BN] if is_bn else []), leaf)


def state_dict_to_flax(state_dict) -> dict:
    """state_dict -> flax {"params", "batch_stats"} tree of float32 numpy arrays."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        collection, (*mods, leaf) = flax_path(key)
        node = tree[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value.detach().cpu().numpy().astype(np.float32)
    return tree


def adam_state_to_flax(optimizer: torch.optim.Adam, named_params, step: int) -> dict:
    """The optax Adam state tree of ``optimizer`` over ``named_params``
    (``(state_dict key, parameter)`` pairs) after ``step`` updates; a
    parameter without state yet has zero moments, as ``optax`` starts."""
    mu, nu = {}, {}
    for name, p in named_params:
        st = optimizer.state.get(p) or {}
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    count = np.asarray(step, np.int32)
    return {"0": {"count": count, "mu": state_dict_to_flax(mu)["params"],
                  "nu": state_dict_to_flax(nu)["params"]},
            "1": {"count": count.copy()}}


def adam_state_from_flax(opt_state: dict, optimizer: torch.optim.Adam, named_params) -> int:
    """Set ``optimizer``'s state for ``named_params`` from an optax Adam
    state tree; returns its count (the updates made). Raises when the
    tree's moments do not name exactly the given parameters."""
    adam, sched = opt_state["0"], opt_state["1"]
    count = int(np.asarray(adam["count"]))
    if int(np.asarray(sched["count"])) != count:
        raise ValueError(f"Adam's count {count} differs from the schedule's "
                         f"{int(np.asarray(sched['count']))}")
    mu = flax_to_state_dict({"params": adam["mu"]})
    nu = flax_to_state_dict({"params": adam["nu"]})
    named = dict(named_params)
    if set(mu) != set(named) or set(nu) != set(named):
        raise ValueError(f"Adam moments for {sorted(set(mu) ^ set(named))[:5]} do not match "
                         "the model's parameters")
    for name, p in named.items():
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"Adam moments of {name}: {tuple(mu[name].shape)}, "
                             f"want {tuple(p.shape)}")
        optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": mu[name].to(p.device),
                              "exp_avg_sq": nu[name].to(p.device)}
    return count


def init_variables(subdivisions: int = 5, widths=(64, 128, 256), seed: int = 0,
                   random_stats: bool = False, model: str = "ico2ico",
                   latent_features: int = 512) -> dict:
    """A seeded variable tree of ``model`` (``"ico2ico"``, the IcoAE, or
    ``"ico2ico_vae"``, the IcoVAE with ``latent_features``) in the JAX init
    recipe: conv taps and bias U(±1/sqrt(7·C_in))
    (``layers.py:hex_uniform_init``), head kernel and bias
    U(±1/sqrt(fan_in)), BN scale 1, bias 0, mean 0, var 1. ``random_stats``
    draws non-trivial BN affines and running statistics instead, so that
    eval-mode BN is exercised."""
    from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE

    if model.endswith("_vae"):
        net = IcoVAE(subdivisions, widths, latent_features, device="meta")
    else:
        net = IcoAE(subdivisions, widths, device="meta")
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    rng = np.random.RandomState(seed)
    sd = {}
    for key in sorted(shapes):
        shape, leaf = shapes[key], key.rsplit(".", 1)[-1]
        mod = key.rsplit(".", 1)[0]
        if _is_bn(mod.rsplit(".", 1)[-1]):
            if not random_stats:
                fill = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}[leaf]
                v = np.full(shape, fill, np.float32)
            elif leaf in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = 0.1 * rng.randn(*shape)
        else:
            fan_in = (shapes[f"{mod}.kernel"][0] if mod.endswith("head")
                      else 7 * shapes[f"{mod}.taps"][1])
            bound = 1.0 / fan_in**0.5
            v = rng.uniform(-bound, bound, shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    return state_dict_to_flax(sd)
