"""Test and decode drivers (reference experiment_test, run.py:499-536).

Port of ``geniconet_tpu/eval/test_driver.py``. ``run_test`` restores the
best (or a named-epoch) checkpoint into a ``Trainer``'s model, reconstructs
the split in batches in eval mode, turns each grid into its vertex list and
takes the per-mesh mean of the squared point-to-mesh distances from the
reconstruction's vertices to the reference mesh on the same faces (kaolin
0.9.1's convention, ``ops/point_mesh.py``); then the distances CSV (and a
histogram PNG where matplotlib imports) with mean ± std and the median
(reference ico_utils.py:46-64), and optionally the reconstructed ``.off``
meshes. ``run_decode`` decodes saved latents (``--process encode``'s
``arr_0``) the same way. The model, the reconstruction and the distances
run on ``cfg.device`` (the card unless ``--device cpu``), one copy to the
host a batch. A ragged last batch runs at its own size: no per-mesh result
depends on the batch.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch

from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.data.datasets import IcoDataset, natural_sort
from geniconet_tpu_torch.data.offio import write_off
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.models import IcoVAE
from geniconet_tpu_torch.ops.point_mesh import pair_chunk, point_to_mesh_distance
from geniconet_tpu_torch.ops.vertices import grid_to_vertices
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config
from geniconet_tpu_torch.train.trainer import Trainer, fresh_variables

__all__ = ["resolve_checkpoint", "restore_model", "reconstruct", "distance_chunk",
           "save_distances", "run_test", "run_decode"]


def distance_chunk(device: torch.device, n_points: int) -> int:
    """Triangles a step of ``point_to_mesh_distance`` for ``n_points`` points
    (its result does not depend on it): on the card ``pair_chunk`` (2,048 at
    s=5, fewer as the points grow); on a CPU about a million (point,
    triangle) pairs, at least 128, so that a step's (P, chunk) tensors stay
    in the caches and a small mesh takes few steps."""
    return pair_chunk(n_points) if device.type == "cuda" else max(128, (1 << 20) // n_points)


def resolve_checkpoint(cfg: Config) -> str:
    """``--test_epoch`` -> a checkpoint path (reference run.py:343-349): 0
    the newest EB file, ``B<epoch>`` that EB file, an int that E file."""
    name = cfg.model.name
    ckpt_dir = os.path.join(cfg.model_log_dir(), "savedModel")
    ep = str(cfg.test_epoch)
    if ep in ("0", ""):
        epoch = ckpt.latest_best_epoch(ckpt_dir, name)
        if epoch is None:
            raise FileNotFoundError(f"no EB checkpoints under {ckpt_dir}")
        return ckpt.checkpoint_path(ckpt_dir, name, epoch, best=True)
    if ep.startswith("B"):
        return ckpt.checkpoint_path(ckpt_dir, name, int(ep[1:]), best=True)
    return ckpt.checkpoint_path(ckpt_dir, name, int(ep), best=False)


def restore_model(cfg: Config, path: str, **routing):
    """(model in eval mode on ``cfg.device``, epoch) of the checkpoint at
    ``path``, through ``Trainer.restore``; ``routing``: the ``Trainer``'s
    routing options."""
    trainer = Trainer(cfg, device=cfg.device, **routing)
    state = trainer.init_state(fresh_variables(cfg), seed=cfg.train.seed)
    _, epoch, _ = trainer.restore(state, path)
    return trainer.model.eval(), epoch


def reconstruct(model, x: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) float32 vertices of an eval-mode model's reconstruction of
    the grids x (the VAE decodes mu); spans ``reconstruct`` > ``forward``,
    ``vertices``."""
    with tracing.unit("reconstruct"):
        with tracing.span("forward"):
            recon = (model(x, train=False, sample=False)[0] if isinstance(model, IcoVAE)
                     else model(x))
        with tracing.span("vertices"):
            return grid_to_vertices(recon, model.subdivisions)


def save_distances(name_dist_pairs, path: str):
    """``<path>.csv`` (and ``<path>.png`` where matplotlib imports), then the
    printed ``mean +- std, Median`` line (reference ico_utils.py:46-64).
    Returns (mean, std, median)."""
    dists = np.asarray([d for _, d in name_dist_pairs], np.float64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".csv", "w") as f:
        f.write("Name,Distance\n")
        for n, d in name_dist_pairs:
            f.write(f"{n},{d:f}\n")
    title = "(%0.8f ± %0.8f) (Median: %0.8f)" % (dists.mean(), dists.std(), np.median(dists))
    try:
        import matplotlib
    except ImportError as e:
        print(f"[test] histogram skipped: {e}")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.hist(dists)
        plt.xlabel("Distance")
        plt.xticks(rotation=30)
        plt.ylabel(f"Frequency (total={len(dists)})")
        plt.title(f"Histogram of {os.path.basename(path)}\n{title}")
        plt.savefig(path + ".png")
        plt.close()
    print("%s: %0.8f +- %0.8f, Median: %0.8f"
          % (os.path.basename(path), dists.mean(), dists.std(), np.median(dists)))
    return float(dists.mean()), float(dists.std()), float(np.median(dists))


def _batched_distances(test_mode: str, pred_v: torch.Tensor, ref_v: torch.Tensor,
                   faces: torch.Tensor) -> torch.Tensor:
    """(b,) per-mesh distance of (b, V, 3) vertices to (b, V, 3) references
    on ``faces``, on their device: ``point2mesh`` the mean squared
    point-to-mesh distance, one mesh at a time (a batch would multiply the
    (P, chunk) pair tensors by b); ``point2point`` the mean vertex distance;
    ``none`` NaN (the reference's ``--test_mode None``: no metric)."""
    if test_mode == "point2mesh":
        chunk = distance_chunk(pred_v.device, pred_v.shape[1])
        return torch.stack([point_to_mesh_distance(p, r, faces, chunk).mean()
                            for p, r in zip(pred_v, ref_v)])
    if test_mode == "point2point":
        return torch.linalg.vector_norm(pred_v - ref_v, dim=-1).mean(dim=-1)
    if test_mode == "none":
        return torch.full(pred_v.shape[:1], float("nan"), device=pred_v.device)
    raise ValueError(f"unknown test_mode {test_mode}")


@torch.no_grad()
def _eval_vertex_batches(cfg: Config, infer, inputs: np.ndarray, names, targets: np.ndarray,
                         out_dir: str | None, device: torch.device):
    """The test and decode loop: ``infer`` (a batch of inputs on ``device``
    -> (b, V, 3) vertices) over batches of ``cfg.train.batch_size``, the
    per-mesh distances to ``targets``' positions (NaN without targets),
    optional ``.off`` files. Returns [(name, distance)]."""
    test_mode = cfg.test_mode if targets is not None else "none"
    faces_np = ico.get_ico_faces(cfg.model.subdivisions)
    faces = torch.as_tensor(faces_np, device=device)
    bs = min(cfg.train.batch_size, len(names))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    pairs = []
    for i0 in range(0, len(names), bs):
        pred_v = infer(torch.as_tensor(inputs[i0 : i0 + bs], device=device))
        ref_v = None if targets is None else torch.as_tensor(targets[i0 : i0 + bs, :, :3],
                                                             device=device)
        d = _batched_distances(test_mode, pred_v, ref_v, faces).cpu().numpy()
        verts = pred_v.cpu().numpy() if out_dir is not None else None
        for k in range(len(d)):
            pairs.append((names[i0 + k], float(d[k])))
            if out_dir is not None:
                write_off(os.path.join(out_dir, names[i0 + k] + ".off"), verts[k], faces_np)
    return pairs


def run_test(cfg: Config, dataset: IcoDataset, write_meshes: bool | None = None, **routing):
    """Evaluate a trained model on ``dataset``; returns ((name, distance)
    pairs, (mean, std, median) or None for ``test_mode`` none).
    ``write_meshes=None`` defers to ``cfg.write_output_mesh`` (the
    reference's ``--write_output_mesh``, run.py:567: no meshes by default)."""
    if write_meshes is None:
        write_meshes = cfg.write_output_mesh
    name = cfg.model.name
    path = resolve_checkpoint(cfg)
    model, epoch = restore_model(cfg, path, **routing)
    print(f"[test] loaded {path} (epoch {epoch})")
    out_dir = os.path.join(cfg.out_dir or os.path.join(cfg.model_log_dir(), "data"), "test")
    pairs = _eval_vertex_batches(cfg, partial(reconstruct, model), dataset.inputs,
                                 dataset.names, dataset.targets,
                                 out_dir if write_meshes else None, next(model.parameters()).device)
    if cfg.test_mode == "none":
        print(f"[test] {len(pairs)} meshes evaluated (test_mode none: no metric)")
        return pairs, None
    return pairs, save_distances(pairs, os.path.join(cfg.model_log_dir(),
                                                     f"{name}_{cfg.test_mode}"))


def run_decode(cfg: Config, reference: IcoDataset | None = None, write_meshes: bool = True,
               **routing):
    """Decode saved latents through the decoder half (reference
    createenc2icoDataset flow, data.py:121-148): ``arr_0`` of every ``.npz``
    under ``cfg.enc_dir`` (default ``<out>/enc/val``, as ``--process
    encode`` writes it) -> meshes under ``<out>/dec``; given ``reference``,
    the per-mesh distances to its meshes of the same names, saved as by
    ``run_test``. Returns (pairs, stats or None)."""
    s, name = cfg.model.subdivisions, cfg.model.name
    out_root = cfg.out_dir or os.path.join(cfg.model_log_dir(), "data")
    enc_dir = cfg.enc_dir or os.path.join(out_root, "enc", "val")
    files = [f for f in natural_sort(os.listdir(enc_dir)) if f.endswith(".npz")]
    if not files:
        raise FileNotFoundError(f"no .npz encodings under {enc_dir}")
    names = [os.path.splitext(f)[0] for f in files]
    zs = []
    for f in files:
        with np.load(os.path.join(enc_dir, f)) as z:
            zs.append(z["arr_0"].astype(np.float32))
    zs = np.stack(zs)

    path = resolve_checkpoint(cfg)
    model, epoch = restore_model(cfg, path, **routing)
    print(f"[decode] loaded {path} (epoch {epoch}); {len(names)} encodings from {enc_dir}")
    device = next(model.parameters()).device

    def infer(z):
        return grid_to_vertices(model.decode(z), s)

    out_dir = os.path.join(out_root, "dec") if write_meshes else None
    if reference is None:  # decode and write the meshes only
        return _eval_vertex_batches(cfg, infer, zs, names, None, out_dir, device), None
    by_name = {n: k for k, n in enumerate(reference.names)}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"encodings without reference meshes: {missing[:5]}...")
    targets = reference.targets[[by_name[n] for n in names]]
    pairs = _eval_vertex_batches(cfg, infer, zs, names, targets, out_dir, device)
    return pairs, save_distances(pairs, os.path.join(cfg.model_log_dir(),
                                                     f"{name}_decode_{cfg.test_mode}"))
