"""The configuration tree and the command line.

The port's own copy of ``geniconet_tpu/train/config.py``: the ``Config``
dataclasses with the fields the port reads, under the same names and with
the same defaults (the tests hold them equal), the per-model presets, and
``parse_args``, which takes the JAX package's flags. A JAX ``Config`` can be
passed wherever the port takes one.

One field is the port's own: ``Config.device`` (``--device``, default
``"cuda"``), the device every entry point runs on; ``--device cpu`` runs the
kernels' plain versions on the CPU. Four JAX flags parse and change nothing,
because the port always does what they select or has no such machinery:
``--use_pallas`` (the port always runs its kernels), ``--no_data_parallel``
(it runs on one device), ``--deviceResident`` (its batches always live on
the device) and ``--backend_retries`` (the TPU's transient-error retry,
which is not ported).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["ModelConfig", "OptimConfig", "DataConfig", "TrainConfig", "Config",
           "apply_model_presets", "parse_args"]


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclass
class ModelConfig:
    name: str = "ico2ico"  # 'ico2ico' (AE) | 'ico2ico_vae' (VAE)
    subdivisions: int = 5
    widths: tuple = (64, 128, 256)
    latent_features: int = 512  # VAE only
    corner_mode: str = "average"
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def is_vae(self) -> bool:
        return self.name.endswith("_vae")


@dataclass
class OptimConfig:
    # reference run.py:632-671: Adam + per-batch CyclicLR(triangular)
    lr_base: float = 1e-9
    lr_max: float = 1e-3
    step_size_up: int = 2000  # torch CyclicLR defaults
    step_size_down: int = 2000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass
class DataConfig:
    data_dir: str = ""
    layout_level: int = 2  # 1 = flat (SHREC), 2 = class/{train,test} (ModelNet)
    ext: str = ".npz"
    synthetic: int = 0  # >0: use a synthetic dataset of this size (no files)
    synthetic_seed: int = 0


@dataclass
class TrainConfig:
    batch_size: int = 12
    train_epoch: int = 600
    save_epoch_freq: int = 100
    log_freq: int = 10
    log_mesh_epoch: int = 50
    quick_learn: int = 0
    seed: int = 0
    load_pretrained_model: bool = False
    load_epoch: int = 0
    # VAE loss factor schedule (reference run.py:651-654)
    factor_step_size: int = 25
    factor_gamma: float = 0.9
    debug_nans: bool = False  # torch.autograd anomaly detection (reference run.py:237)
    log_grad_freq: int = 1000   # per-parameter grad-norm logging period (0 = off)
    # encoding-logging period (0 = off): the AE logs the bottleneck of the
    # first 3 validation samples, the VAE mu/logvar/reparam of the first
    # (reference run.py:167-215, 83-96)
    log_encoding_epoch: int = 0
    # True: histograms (reference VAE default, run.py:665); False: channel
    # images sampling one of six channel groups (reference run.py:203-211)
    log_encoding_hist: bool = True
    profile_dir: str = ""       # torch.profiler trace of epoch start+1
    debug_timing: bool = False  # print per-epoch step timing (--debug)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "log"
    process: str = "train"  # 'train' | 'test' | 'encode' | 'decode' | 'sample'
    test_epoch: str = "0"   # 0 = latest best, 'B<ep>' or int for specific
    test_mode: str = "point2mesh"  # 'point2mesh' | 'point2point' | 'none'
    data_instance: str = "val"  # dataset split for test/encode (reference --data_instance)
    write_output_mesh: bool = False  # test: dump reconstructed .off (reference flag)
    n_samples: int = 8      # sample process: meshes drawn from checkpoint misc
    out_dir: str = ""
    enc_dir: str = ""       # decode process: directory of latent .npz files
    load_pt: str = ""       # a reference .pt checkpoint to import (train/pt_import.py)
    # optional per-term loss-factor overrides (None -> per-model defaults,
    # reference run.py:689-696)
    f_pos: Optional[float] = None
    f_nor: Optional[float] = None
    f_lap: Optional[float] = None
    f_kl: Optional[float] = None
    device: str = "cuda"    # the port's own: where the CLI's processes run

    def model_log_dir(self) -> str:
        return os.path.join(self.log_dir, "vae" if self.model.is_vae else "ae")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["git_sha"] = _git_sha()  # reference records repo SHAs (run.py:715-716)
        return json.dumps(d, indent=2, default=str)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())


def apply_model_presets(cfg: Config):
    """Per-model hyperparameter blocks (reference run.py:632-671)."""
    if cfg.model.is_vae:
        cfg.train.save_epoch_freq = 50
        cfg.train.log_freq = 20
        cfg.train.log_mesh_epoch = 25
        cfg.train.log_encoding_epoch = 50
    else:
        cfg.train.save_epoch_freq = 100
        cfg.train.log_freq = 10
        cfg.train.log_mesh_epoch = 50
        cfg.train.log_encoding_epoch = 0  # reference AE default (run.py:643)
    return cfg


def parse_args(argv=None) -> Config:
    """The JAX package's command line (reference run.py:538-587), and ``--device``."""
    p = argparse.ArgumentParser(description="GenIcoNet experiment runner (PyTorch port)")
    p.add_argument("--model", choices=["ico2ico", "ico2ico_vae"], required=True)
    p.add_argument("--process", choices=["train", "test", "encode", "decode", "sample"],
                   required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of every process (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--data_instance", choices=["trn", "val"], default="val",
                   help="dataset split for test/encode (reference run.py:546)")
    p.add_argument("--test_mode", choices=["point2mesh", "point2point", "none"], default=None,
                   help="test metric; 'none' skips distances (reference run.py:565)")
    p.add_argument("--write_output_mesh", action="store_true",
                   help="test: write reconstructed .off meshes (reference run.py:567)")
    p.add_argument("--corner_mode", choices=["average", "zeros"], default=None,
                   help="pole-corner synthesis mode (reference run.py:683)")
    p.add_argument("--n_samples", type=int, default=8,
                   help="sample process: meshes drawn from the checkpoint's misc")
    p.add_argument("--backend_retries", type=int, default=None,
                   help="accepted for the JAX command line; no effect in the port")
    p.add_argument("--log_encoding_epoch", type=int, default=None,
                   help="encoding-logging period (reference run.py:643,664)")
    p.add_argument("--log_encoding_images", action="store_true",
                   help="log channel images instead of histograms (reference run.py:203-211)")
    p.add_argument("--deviceResident", choices=["auto", "on", "off"], default="auto",
                   help="accepted for the JAX command line; the port's batches always "
                        "live on the device")
    # optimizer block (reference run.py:632-671: Adam + per-batch CyclicLR)
    p.add_argument("--lr_base", type=float, default=None)
    p.add_argument("--lr_max", type=float, default=None)
    p.add_argument("--step_size_up", type=int, default=None)
    p.add_argument("--step_size_down", type=int, default=None)
    # loss-factor block (reference run.py:689-696)
    p.add_argument("--f_pos", type=float, default=None)
    p.add_argument("--f_nor", type=float, default=None)
    p.add_argument("--f_lap", type=float, default=None)
    p.add_argument("--f_kl", type=float, default=None)
    p.add_argument("--encDir", type=str, default="",
                   help="decode process: directory of latent .npz files")
    p.add_argument("--dataDir", type=str, default="")
    p.add_argument("--logDir", type=str, default="log")
    p.add_argument("--outDir", type=str, default="")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--train_epoch", type=int, default=None)
    p.add_argument("--test_epoch", type=str, default=None)
    p.add_argument("--load_epoch", type=int, default=None)
    p.add_argument("--load_pt", type=str, default="",
                   help="import a reference PyTorch .pt checkpoint as the newest EB file")
    p.add_argument("--load_pretrained_model", action="store_true")
    p.add_argument("--subdivision", type=int, default=5)
    p.add_argument("--dataPthLvl", type=int, default=2)
    p.add_argument("--quickLearn", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic meshes instead of --dataDir")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--widths", type=int, nargs=3, default=None, metavar=("W0", "W1", "W2"),
                   help="encoder/decoder stage widths (default 64 128 256)")
    p.add_argument("--latent_features", type=int, default=None)
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for the JAX command line; the port always runs its kernels")
    p.add_argument("--no_data_parallel", action="store_true",
                   help="accepted for the JAX command line; the port runs on one device")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--debug", action="store_true", help="print per-epoch timing")
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    cfg = Config()
    cfg.model.name = a.model
    cfg.model.subdivisions = a.subdivision
    cfg.process = a.process
    cfg.device = a.device
    cfg.log_dir = a.logDir
    cfg.out_dir = a.outDir  # empty -> <model_log_dir>/data at the use site
    cfg.enc_dir = a.encDir
    cfg.load_pt = a.load_pt
    cfg.data.data_dir = a.dataDir
    cfg.data.layout_level = a.dataPthLvl
    cfg.data.synthetic = a.synthetic
    apply_model_presets(cfg)
    if a.batch_size is not None:
        cfg.train.batch_size = a.batch_size
    if a.train_epoch is not None:
        cfg.train.train_epoch = a.train_epoch
    if a.test_epoch is not None:
        cfg.test_epoch = a.test_epoch
    if a.test_mode is not None:
        cfg.test_mode = a.test_mode
    cfg.data_instance = a.data_instance
    cfg.write_output_mesh = a.write_output_mesh
    cfg.n_samples = a.n_samples
    if a.log_encoding_epoch is not None:
        cfg.train.log_encoding_epoch = a.log_encoding_epoch
    if a.log_encoding_images:
        cfg.train.log_encoding_hist = False
    if a.corner_mode is not None:
        cfg.model.corner_mode = a.corner_mode
    for f in ("lr_base", "lr_max", "step_size_up", "step_size_down"):
        if getattr(a, f) is not None:
            setattr(cfg.optim, f, getattr(a, f))
    for f in ("f_pos", "f_nor", "f_lap", "f_kl"):
        if getattr(a, f) is not None:
            setattr(cfg, f, getattr(a, f))
    if a.load_epoch is not None:
        cfg.train.load_epoch = a.load_epoch
        cfg.train.load_pretrained_model = True
    if a.load_pretrained_model:
        cfg.train.load_pretrained_model = True
    cfg.train.quick_learn = a.quickLearn
    cfg.train.seed = a.seed
    cfg.train.debug_nans = a.debug_nans
    cfg.train.debug_timing = a.debug
    cfg.train.profile_dir = a.profile_dir
    if a.compute_dtype:
        cfg.model.compute_dtype = a.compute_dtype
    if a.widths:
        cfg.model.widths = tuple(a.widths)
    if a.latent_features is not None:
        if a.latent_features <= 0:
            raise SystemExit("--latent_features must be positive")
        cfg.model.latent_features = a.latent_features
    return cfg
