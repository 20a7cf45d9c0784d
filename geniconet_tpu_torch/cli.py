"""Experiment CLI of the port: train, resume, test, encode, decode and sample.

Port of ``geniconet_tpu/cli.py`` (the reference's run.py), with the JAX
package's flags (``train/config.py:parse_args``)::

    python -m geniconet_tpu_torch.cli --model ico2ico     --process train --dataDir <npz root>
    python -m geniconet_tpu_torch.cli --model ico2ico_vae --process train --synthetic 64 \
        --compute_dtype bfloat16 --batch_size 36 --train_epoch 3
    python -m geniconet_tpu_torch.cli --model ico2ico --process train ... --load_pretrained_model
    python -m geniconet_tpu_torch.cli --model ico2ico --process test --write_output_mesh ...
    python -m geniconet_tpu_torch.cli --model ico2ico --process encode ...
    python -m geniconet_tpu_torch.cli --model ico2ico --process decode ...
    python -m geniconet_tpu_torch.cli --model ico2ico_vae --process sample ...
    python -m geniconet_tpu_torch.cli --model ico2ico --load_pt ico2ico_EB696.pt --process test ...
    torchrun --nproc_per_node 4 -m geniconet_tpu_torch.cli --model ico2ico --process train \
        --subdivision 6 --synthetic 64 --compute_dtype bfloat16 --batch_size 36

Every process runs on the card unless ``--device cpu`` is given. Under
``torchrun`` training is data-parallel over the ranks (``parallel/dist.py``;
``--batch_size`` is the global batch, which the ranks must divide) unless
``--no_data_parallel`` is given, which torchrun with more than one rank
refuses; rank r runs on ``cuda:LOCAL_RANK``, over NCCL when each rank has a
card and gloo when ranks share one (or ``--device cpu``), and rank 0 alone
logs and writes checkpoints.
Checkpoints are the JAX package's ``.ckpt`` files under
``<logDir>/<ae|vae>/savedModel``, so either package resumes or serves the
other's; ``--load_pt`` first turns a reference ``.pt`` file into such an
EB file. The training routing comes from the JAX package's own variables,
read as it reads them (``routing_from_env``). The TPU's retry after
transient backend errors is not ported.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from geniconet_tpu_torch.app.state import AppState
from geniconet_tpu_torch.bridge import adam_state_to_flax, flatten_tree
from geniconet_tpu_torch.data.datasets import IcoDataset, synthetic_dataset
from geniconet_tpu_torch.data.offio import write_off
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.eval.test_driver import resolve_checkpoint, run_decode, run_test
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.ops.vertices import grid_to_vertices
from geniconet_tpu_torch.parallel import dist as dist_lib
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.config import Config, parse_args
from geniconet_tpu_torch.train.logging import Logger
from geniconet_tpu_torch.train.pt_import import load_reference_checkpoint
from geniconet_tpu_torch.train.summary import count_params, model_graph_dot, model_summary
from geniconet_tpu_torch.train.trainer import Trainer, fresh_variables

__all__ = ["load_datasets", "routing_from_env", "resume_path", "data_parallel",
           "experiment_train",
           "experiment_test", "experiment_encode", "experiment_decode", "experiment_sample",
           "import_pt_checkpoint", "main"]


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


def data_parallel(cfg: Config):
    """This rank's ``DataParallel`` when the process runs under torchrun
    (``WORLD_SIZE`` set) and ``cfg.train.data_parallel``, else None; the
    process group starts here. ``--no_data_parallel`` under torchrun with
    more than one rank raises: each rank would train alone into the same
    files."""
    if "WORLD_SIZE" not in os.environ:
        return None
    if not cfg.train.data_parallel:
        if int(os.environ["WORLD_SIZE"]) > 1:
            raise SystemExit("--no_data_parallel under torchrun with more than one rank: "
                             "run one process without torchrun instead")
        return None
    dp = dist_lib.init(device_type=torch.device(cfg.device).type)
    print(f"[train] data parallel: {dp}", flush=True)
    return dp


def experiment_train(cfg: Config):
    """Train (or resume) and return the validation history (reference
    experiment_train, run.py:412-497); data-parallel under torchrun
    (``data_parallel``)."""
    trn_ds, val_ds = load_datasets(cfg)
    if cfg.train.quick_learn:
        trn_ds = val_ds  # smoke-test mode (reference run.py:416-421)
    dp = data_parallel(cfg)
    main = dp is None or dp.rank == 0
    log_dir = cfg.model_log_dir()
    logger = Logger(log_dir) if main else None
    try:
        if main:
            cfg.save(os.path.join(log_dir, "config.json"))
            logger.text("config", cfg.to_json())
        routing = routing_from_env()
        trainer = Trainer(cfg, device=cfg.device, logger=logger, dp=dp, **routing)
        if main:
            print(f"[train] device {trainer.device}, routing {routing}")
        variables = fresh_variables(cfg)
        state = trainer.init_state(variables, seed=cfg.train.seed)
        if main:
            print(f"[train] optimizable parameters: {count_params(variables['params'])}")
            # the parameter table and the graph drawing at train start
            # (torchsummary's summary_string/draw_graph, reference run.py:427-430)
            summ = model_summary(variables)
            with open(os.path.join(log_dir, f"train_{cfg.model.name}_summary.txt"), "w") as f:
                f.write(summ)
            logger.text("model_summary", summ)
            dot = model_graph_dot(variables, type(trainer.model).__name__,
                                  trn_ds.inputs[:1].shape)
            with open(os.path.join(log_dir, f"train_{cfg.model.name}_graph.dot"), "w") as f:
                f.write(dot)
        start_epoch, best_loss = 0, math.inf
        if cfg.train.load_pretrained_model:
            path = resume_path(cfg)
            if path and os.path.exists(path):
                state, start_epoch, best_loss = trainer.restore(state, path)
                print(f"[train] resumed from {path} (epoch {start_epoch}, best {best_loss:.5f})")
            else:
                print("[train] no checkpoint found to resume; starting fresh")
        bs = cfg.train.batch_size
        shard = {} if dp is None else dict(rank=dp.rank, world=dp.world)
        trn = Batches(trn_ds, bs, shuffle=True, seed=cfg.train.seed, device=trainer.device,
                      **shard)
        val = Batches(val_ds, bs, shuffle=False, device=trainer.device, **shard)
        # the reference's detect_anomaly (run.py:237) under --debug_nans
        with torch.autograd.set_detect_anomaly(cfg.train.debug_nans):
            _, history = trainer.fit(state, trn, val, start_epoch, best_loss)
    finally:
        if logger is not None:
            logger.close()
        if dp is not None:
            torch.distributed.destroy_process_group()
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


def _test_dataset(cfg: Config) -> IcoDataset:
    """The ``--data_instance`` split (reference run.py:546): ``--synthetic
    N`` meshes of the training (trn) or validation (val) seed, else that
    split of ``--dataDir``."""
    s = cfg.model.subdivisions
    if cfg.data.synthetic:
        off = 0 if cfg.data_instance == "trn" else 1
        return synthetic_dataset(s, cfg.data.synthetic, seed=cfg.data.synthetic_seed + off)
    return IcoDataset.from_directory(cfg.data.data_dir, s, cfg.data.layout_level,
                                     cfg.data_instance, cfg.data.ext, cfg.train.quick_learn)


def experiment_test(cfg: Config):
    """Per-mesh distances of the reconstructions of the test split
    (``eval/test_driver.py:run_test``); returns (pairs, stats)."""
    return run_test(cfg, _test_dataset(cfg), **routing_from_env())


def experiment_decode(cfg: Config):
    """Decode a directory of encodings through the decoder half (reference
    enc2ico flow, data.py:121-148), with distances to the meshes of the
    same names where a dataset is given: ``--synthetic N`` the meshes
    ``--process encode`` encoded (``AppState.load``'s seed), else the
    ``--data_instance`` split of ``--dataDir``. Returns (pairs, stats)."""
    ref = None
    if cfg.data.synthetic:
        ref = synthetic_dataset(cfg.model.subdivisions, cfg.data.synthetic,
                                seed=cfg.data.synthetic_seed)
    elif cfg.data.data_dir:
        ref = _test_dataset(cfg)
    return run_decode(cfg, ref, **routing_from_env())


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


def _misc(raw):
    """The reference's ``misc`` (run.py:274-277: ``[{'trn_mean', 'trn_logvar'}]``)
    as the ``.ckpt`` files keep it, or None."""
    entry = raw[0] if isinstance(raw, (list, tuple)) and raw else raw
    if isinstance(entry, dict) and "trn_mean" in entry:
        return {"trn_mean": np.asarray(entry["trn_mean"], np.float32),
                "trn_logvar": np.asarray(entry["trn_logvar"], np.float32)}
    return None


def import_pt_checkpoint(cfg: Config) -> str:
    """``--load_pt``: a reference ``.pt`` checkpoint -> an EB ``.ckpt`` under
    ``<logDir>/<ae|vae>/savedModel`` with fresh Adam moments, which every
    later process (resume, test, encode, decode, sample, the explorer)
    finds as the newest EB file (reference run.py:330-340). Every leaf must
    fit the configured model. Returns the file's path."""
    imported = load_reference_checkpoint(cfg.load_pt, cfg.model.name)
    trainer = Trainer(cfg, device=cfg.device)
    live = fresh_variables(cfg)
    state = trainer.init_state(live, seed=cfg.train.seed)
    bad = []
    for col in ("params", "batch_stats"):
        want = {"/".join(p): tuple(v.shape) for p, v in flatten_tree(live[col])}
        got = {"/".join(p): tuple(v.shape) for p, v in flatten_tree(imported[col])}
        bad += [f"{col}/{k}: model {want.get(k)} vs checkpoint {got.get(k)}"
                for k in sorted(want.keys() | got.keys()) if want.get(k) != got.get(k)]
    if bad:
        raise ValueError(f"imported variables do not fit the configured model (--model "
                         f"{cfg.model.name}, subdivision {cfg.model.subdivisions}, widths "
                         f"{cfg.model.widths}): " + "; ".join(bad[:5]))
    loss = math.inf if imported["loss"] is None else imported["loss"]
    epoch = imported["epoch"]
    blob = {"params": imported["params"], "batch_stats": imported["batch_stats"],
            "opt_state": adam_state_to_flax(state.optimizer, trainer.model.named_parameters(), 0),
            "step": 0, "epoch": epoch, "loss": loss, "best_loss": loss}
    misc = _misc(imported["misc"])
    if misc is not None:
        blob["misc"] = misc
    path = ckpt.checkpoint_path(os.path.join(cfg.model_log_dir(), "savedModel"), cfg.model.name,
                                epoch, best=True)
    ckpt.save_checkpoint(path, blob)
    print(f"[load_pt] imported {cfg.load_pt} -> {path} (epoch {epoch})")
    return path


def main(argv=None):
    """Parse the command line, import ``--load_pt`` if given, and run the
    process; returns what it returns."""
    cfg = parse_args(argv)
    if cfg.load_pt:
        import_pt_checkpoint(cfg)
    run = {"train": experiment_train, "test": experiment_test, "encode": experiment_encode,
           "decode": experiment_decode, "sample": experiment_sample}[cfg.process]
    return run(cfg)


if __name__ == "__main__":
    main()
