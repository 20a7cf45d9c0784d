"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``benchmark/limits/<cell>.json``; PERF.md gives the
readings each limit was set from).

Training (the first steps of the run, followed by the reference):
  loss_gap    the largest |program - reference| / |reference| of a step's loss;
  grad_gap    over the trained leaves, the largest gap between the norm of
              the program's first gradient (as Adam received it, read back
              from its first moment) and the reference's, over the larger
              of the reference's norm of that leaf and of the median leaf;
  change_gap  the same for the norm of each leaf's change over the steps;
  stats_gap   over every BatchNorm's mean and variance of the first step's
              batch (the program's read back from its running statistics),
              the largest norm of their difference over the larger of the
              reference's norm and the median one.
grad_gap and change_gap leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: a conv bias under BatchNorm, whose gradient is nought
but round-off on either side (the program's, summed over every position of
a bfloat16 cotangent, reads up to 2.4 times the median leaf's), and which
Adam moves by round-off alone.
Reconstruction:
  recon_err   over a sample of the window's meshes, the largest RMS of
              program - reference vertices over the RMS of the reference's.
"""

from __future__ import annotations

import math
import statistics

import torch

STILL = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _moved(ref_norms: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_norms.values())
    return [k for k in sorted(ref_norms) if ref_norms[k] >= STILL * med]


def _leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    return max(_leaf_gaps(prog, ref, keys).values())


def worst_leaves(prog_grad1: dict, ref_grad1: dict, prog_delta: dict, ref_delta: dict,
                 n: int = 4) -> dict:
    """The ``n`` leaves with the largest gaps of each number, for a look at
    what sets it."""
    pg, rg = _norms(prog_grad1), _norms(ref_grad1)
    moved = _moved(rg)
    out = {}
    for name, gaps in (("grad_all_leaves", _leaf_gaps(pg, rg, sorted(rg))),
                       ("grad", _leaf_gaps(pg, rg, moved)),
                       ("change", _leaf_gaps(_norms(prog_delta), _norms(ref_delta), moved))):
        out[name] = [[k, round(v, 5)] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]
    return out


def training(prog_losses, ref_losses, prog_grad1: dict, ref_grad1: dict, prog_delta: dict,
             ref_delta: dict, prog_moments: dict, ref_moments: dict) -> dict:
    """The four numbers; the gradient and change dicts map a parameter name
    to a tensor, the moments dicts a BatchNorm's name to (mean, var)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    pg, rg = _norms(prog_grad1), _norms(ref_grad1)
    moved = _moved(rg)
    pd, rd = _norms(prog_delta), _norms(ref_delta)
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(pg, rg, moved),
            "change_gap": _leaf_gap(pd, rd, moved),
            "stats_gap": moments_gap(prog_moments, ref_moments)}


def moments_gap(prog: dict, ref: dict) -> float:
    """Over every BatchNorm's batch mean and batch variance of the first
    step, the largest norm of program - reference over the larger of the
    reference's norm and the median one."""
    diff, size = {}, {}
    for name, pair in ref.items():
        for i, leaf in enumerate(("mean", "var")):
            d = prog[name][i].double() - pair[i].double()
            diff[f"{name}.{leaf}"] = float(torch.linalg.vector_norm(d))
            size[f"{name}.{leaf}"] = float(torch.linalg.vector_norm(pair[i].double()))
    med = statistics.median(size.values())
    return max(diff[k] / max(size[k], med) for k in diff)


def reconstruction(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """prog, ref: (n, V, 3) vertices of the same n meshes."""
    d = (prog.double() - ref.double()).pow(2).mean(dim=(1, 2)).sqrt()
    r = ref.double().pow(2).mean(dim=(1, 2)).sqrt()
    return {"recon_err": float((d / r).max())}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: one fails when it is above its limit or not finite. A
    limit of null marks a number that is printed and not compared (PERF.md
    gives why)."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit}
        if limit is not None and not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, out
