"""Experiment CLI of the port: train, resume, encode and sample.

Port of ``geniconet_tpu/cli.py`` (the reference's run.py), with the JAX
package's flags (``train/config.py:parse_args``)::

    python -m geniconet_tpu_torch.cli --model ico2ico     --process train --dataDir <npz root>
    python -m geniconet_tpu_torch.cli --model ico2ico_vae --process train --synthetic 64 \
        --compute_dtype bfloat16 --batch_size 36 --train_epoch 3
    python -m geniconet_tpu_torch.cli --model ico2ico --process train ... --load_pretrained_model
    python -m geniconet_tpu_torch.cli --model ico2ico --process encode ...
    python -m geniconet_tpu_torch.cli --model ico2ico_vae --process sample ...

Every process runs on the card unless ``--device cpu`` is given.
Checkpoints are the JAX package's ``.ckpt`` files under
``<logDir>/<ae|vae>/savedModel``, so either package resumes or serves the
other's. The training routing comes from the JAX package's own variables,
read as it reads them (``routing_from_env``). Not ported yet: ``--process
test`` and ``decode`` (ROADMAP, Queue 1 item 9), ``--load_pt`` (item 11),
the model summary table and graph drawing (item 8); the TPU's retry after
transient backend errors is not ported at all.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.bridge import init_variables
from geniconet_tpu_torch.data.datasets import IcoDataset, synthetic_dataset
from geniconet_tpu_torch.data.offio import write_off
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.vertices import grid_to_vertices
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config, parse_args
from geniconet_tpu_torch.train.logging import Logger
from geniconet_tpu_torch.train.summary import count_params
from geniconet_tpu_torch.train.trainer import Trainer

__all__ = ["load_datasets", "routing_from_env", "resume_path", "resolve_checkpoint",
           "experiment_train", "experiment_encode", "experiment_sample", "main"]


def load_datasets(cfg: Config):
    """(training, validation) datasets: ``--synthetic N`` meshes (and N // 5
    more for validation), else the ``trn`` and ``val`` splits of ``--dataDir``."""
    s = cfg.model.subdivisions
    if cfg.data.synthetic:
        n = cfg.data.synthetic
        trn = synthetic_dataset(s, n, seed=cfg.data.synthetic_seed)
        val = synthetic_dataset(s, max(1, n // 5), seed=cfg.data.synthetic_seed + 1)
        return trn, val
    if not cfg.data.data_dir:
        raise SystemExit("need --dataDir or --synthetic N")
    return tuple(IcoDataset.from_directory(cfg.data.data_dir, s, cfg.data.layout_level, split,
                                           cfg.data.ext, cfg.train.quick_learn)
                 for split in ("trn", "val"))


def routing_from_env() -> dict:
    """The ``Trainer``'s routing options, read from the JAX package's
    variables as it reads them: ``GENICONET_MERGED_BWD``,
    ``GENICONET_PHASE_CHAIN`` and ``GENICONET_MERGED_BLOCK`` count only
    under ``GENICONET_EXPERIMENTAL=1``; ``GENICONET_KERNEL_GEFF`` counts as
    "0" or "" without it, and any other value only with it (else it is "",
    JAX's built-in fold set). A variable that is not set keeps the port's
    default (None)."""
    env = os.environ
    experimental = env.get("GENICONET_EXPERIMENTAL", "0") == "1"
    out = {opt: env.get(var) if experimental else None
           for opt, var in (("merged_bwd", "GENICONET_MERGED_BWD"),
                            ("phase_chain", "GENICONET_PHASE_CHAIN"),
                            ("merged_block", "GENICONET_MERGED_BLOCK"))}
    geff = env.get("GENICONET_KERNEL_GEFF")
    if geff not in (None, "", "0") and not experimental:
        geff = ""
    out["kernel_geff"] = geff
    return out


def resume_path(cfg: Config):
    """The checkpoint ``--load_pretrained_model`` resumes from, as the JAX
    CLI resolves it: ``--load_epoch`` 0 the newest EB file, else that
    epoch's E file, then its EB file; None when there is none."""
    ckpt_dir = os.path.join(cfg.model_log_dir(), "savedModel")
    name, ep = cfg.model.name, cfg.train.load_epoch
    if ep == 0:
        ep = ckpt.latest_best_epoch(ckpt_dir, name)
        return ckpt.checkpoint_path(ckpt_dir, name, ep, best=True) if ep else None
    for best in (False, True):
        path = ckpt.checkpoint_path(ckpt_dir, name, ep, best=best)
        if os.path.exists(path):
            return path
    return None


def resolve_checkpoint(cfg: Config) -> str:
    """``--test_epoch`` -> a checkpoint path (the JAX package's
    ``resolve_checkpoint`` in its eval package, reference run.py:343-349):
    0 the newest EB file, ``B<epoch>`` that EB file, an int that E file."""
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


def _fresh_variables(cfg: Config) -> dict:
    m = cfg.model
    return init_variables(m.subdivisions, tuple(m.widths), seed=cfg.train.seed, model=m.name,
                          latent_features=m.latent_features)


def experiment_train(cfg: Config):
    """Train (or resume) and return the validation history (reference
    experiment_train, run.py:412-497)."""
    trn_ds, val_ds = load_datasets(cfg)
    if cfg.train.quick_learn:
        trn_ds = val_ds  # smoke-test mode (reference run.py:416-421)
    log_dir = cfg.model_log_dir()
    logger = Logger(log_dir)
    try:
        cfg.save(os.path.join(log_dir, "config.json"))
        logger.text("config", cfg.to_json())
        routing = routing_from_env()
        trainer = Trainer(cfg, device=cfg.device, logger=logger, **routing)
        print(f"[train] device {trainer.device}, routing {routing}")
        variables = _fresh_variables(cfg)
        state = trainer.init_state(variables, seed=cfg.train.seed)
        print(f"[train] optimizable parameters: {count_params(variables['params'])}")
        start_epoch, best_loss = 0, math.inf
        if cfg.train.load_pretrained_model:
            path = resume_path(cfg)
            if path and os.path.exists(path):
                state, start_epoch, best_loss = trainer.restore(state, path)
                print(f"[train] resumed from {path} (epoch {start_epoch}, best {best_loss:.5f})")
            else:
                print("[train] no checkpoint found to resume; starting fresh")
        bs = cfg.train.batch_size
        trn = Batches(trn_ds, bs, shuffle=True, seed=cfg.train.seed, device=cfg.device)
        val = Batches(val_ds, bs, shuffle=False, device=cfg.device)
        # the reference's detect_anomaly (run.py:237) under --debug_nans
        with torch.autograd.set_detect_anomaly(cfg.train.debug_nans):
            _, history = trainer.fit(state, trn, val, start_epoch, best_loss)
    finally:
        logger.close()
    return history


def experiment_encode(cfg: Config):
    """Each split's latents as ``.npz`` files under ``<outDir>/enc/<split>``
    (key ``arr_0``, the VAE's also ``logvar``: the format the reference's
    encoding datasets read back, data.py:38-44). Returns the info dicts."""
    st = AppState(device=cfg.device)
    phase_chain = routing_from_env()["phase_chain"]
    infos = []
    for instance in ("trn", "val"):
        try:
            info = st.load(cfg, instance, phase_chain=phase_chain)
        except FileNotFoundError as e:
            print(f"[encode] {instance}: {e}")
            continue
        out_dir = os.path.join(cfg.out_dir or os.path.join(cfg.model_log_dir(), "data"), "enc",
                               instance)
        os.makedirs(out_dir, exist_ok=True)
        for k, name in enumerate(st.dataset.names):
            extra = {} if st.logvars is None else {"logvar": st.logvars[k]}
            np.savez(os.path.join(out_dir, name + ".npz"), st.latents[k], **extra)
        print(f"[encode] wrote {len(st.dataset.names)} encodings to {out_dir}")
        infos.append(info)
    return infos


def experiment_sample(cfg: Config) -> str:
    """Decode ``--n_samples`` latents drawn from the checkpoint's stored
    (mu, logvar) with the reference's formula, verbatim: ``z = mu + logvar ·
    eps`` (models.py:329-332; it scales by logvar itself). Writes
    ``sample_<k>.off`` files and returns their directory."""
    path = resolve_checkpoint(cfg)
    blob = ckpt.load_checkpoint(path)
    misc = blob.get("misc")
    if not misc or "trn_mean" not in misc:
        raise SystemExit(f"{path} carries no (mu, logvar) misc: train a VAE first (an AE "
                         "checkpoint has no latent distribution to sample)")
    mu = np.asarray(misc["trn_mean"], np.float32)
    logvar = np.asarray(misc["trn_logvar"], np.float32)
    rng = np.random.RandomState(cfg.train.seed)
    idx = rng.randint(0, mu.shape[0], size=cfg.n_samples)
    z = mu[idx] + logvar[idx] * rng.randn(*mu[idx].shape).astype(np.float32)

    s = cfg.model.subdivisions
    routing = routing_from_env()
    trainer = Trainer(cfg, device=cfg.device, **routing)
    trainer.init_state({"params": blob["params"], "batch_stats": blob["batch_stats"]})
    with torch.inference_mode():
        recon = trainer.model.decode(torch.as_tensor(z, device=trainer.device))
        verts = grid_to_vertices(recon, s).float().cpu().numpy()
    faces = ico.get_ico_faces(s)
    out_dir = os.path.join(cfg.out_dir or os.path.join(cfg.model_log_dir(), "data"), "sample")
    os.makedirs(out_dir, exist_ok=True)
    for k in range(verts.shape[0]):
        write_off(os.path.join(out_dir, f"sample_{k:03d}.off"), verts[k], faces)
    print(f"[sample] wrote {verts.shape[0]} sampled meshes (epoch {blob['epoch']}) to {out_dir}")
    return out_dir


def main(argv=None):
    """Parse the command line and run its process; returns what it returns."""
    cfg = parse_args(argv)
    if cfg.load_pt:
        raise NotImplementedError("--load_pt: importing the reference's .pt checkpoints is not "
                                  "ported yet (ROADMAP, Queue 1 item 11)")
    if cfg.process in ("test", "decode"):
        raise NotImplementedError(f"--process {cfg.process} is not ported yet (ROADMAP, Queue 1 "
                                  "item 9: eval)")
    run = {"train": experiment_train, "encode": experiment_encode,
           "sample": experiment_sample}[cfg.process]
    return run(cfg)


if __name__ == "__main__":
    main()
