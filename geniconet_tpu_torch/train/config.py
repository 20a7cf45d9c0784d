"""The configuration tree the port reads.

The port's own copy of the ``Config`` dataclasses of
``geniconet_tpu/train/config.py``, kept to the fields the port's trainer,
datasets and explorer backend read, with the same names and defaults (the
tests hold them equal). A JAX ``Config`` can be passed wherever the port
takes one. The command line (``parse_args``) comes with the port's CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = ["ModelConfig", "OptimConfig", "DataConfig", "TrainConfig", "Config"]


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
    quick_learn: int = 0
    # VAE loss factor schedule (reference run.py:651-654)
    factor_step_size: int = 25
    factor_gamma: float = 0.9


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "log"
    # optional per-term loss-factor overrides (None -> per-model defaults,
    # reference run.py:689-696)
    f_pos: Optional[float] = None
    f_nor: Optional[float] = None
    f_lap: Optional[float] = None
    f_kl: Optional[float] = None
