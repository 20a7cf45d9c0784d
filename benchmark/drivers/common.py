"""What the drivers share: the seeds of a run, the program's configuration
object for a cell, and the traced stretch's bookkeeping."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import trace


@dataclass(frozen=True)
class Seeds:
    """Independent 32-bit seeds drawn from the run's ``--seed``."""

    weights: int
    data: int
    shuffle: int
    trainer: int
    sample: int

    @staticmethod
    def of(seed: int) -> "Seeds":
        return Seeds(*(int(x) for x in np.random.SeedSequence(seed).generate_state(5)))


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def program_starts(dev: torch.device):
    """From here the memory peak is the program's: what the benchmark made
    before (inputs, weights, the reference's pass for the running
    statistics) counts only as far as it is still held."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def free(dev: torch.device):
    """Return the memory of dropped tensors, so the reference that runs next
    finds the card as empty as the program's state leaves it."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def program_config(cell):
    """The program's ``Config`` for a cell: the configuration file's model,
    loss factors, optimizer and log cadence, the traffic's level and batch."""
    from geniconet_tpu_torch.train.config import Config

    c, t = cell.config, cell.traffic
    cfg = Config()
    m = c["model"]
    cfg.model.name = m["name"]
    cfg.model.subdivisions = t["subdivisions"]
    cfg.model.widths = tuple(m["widths"])
    cfg.model.latent_features = m["latent_features"]
    cfg.model.corner_mode = m["corner_mode"]
    cfg.model.compute_dtype = m["compute_dtype"]
    for k, v in c["optim"].items():
        setattr(cfg.optim, k, v)
    cfg.f_pos, cfg.f_nor, cfg.f_lap, cfg.f_kl = (c["loss"][k] for k in ("pos", "nor", "lap", "kl"))
    cfg.train.batch_size = t["batch_size"]
    cfg.train.log_freq = c["log_freq"]
    return cfg


class Tracer:
    """Takes one traced stretch of ``units`` steps (or batches) in a run
    with ``--trace 1``: started at the first allowed boundary a third of
    the way into the window, read as soon as it stops; a stretch whose
    trace holds no kernel is taken again, up to three times. ``excluded_ns``
    is the wall time the stretch and its reading took."""

    def __init__(self, on: bool, units: int, window_ns: int):
        self.on, self.units, self.window_ns = on, units, window_ns
        self.stretch, self.ok, self.attempts = None, False, 0
        self.active, self.count, self.least = False, 0, 0.0
        self.excluded_ns, self._t0 = 0, 0

    def boundary(self, elapsed_ns: int, allowed: bool):
        """Call between two steps; ``allowed``: the device has drained here."""
        if not self.on or self.ok or not allowed:
            return
        if self.active and self.count >= self.units:
            self.stretch.stop()
            self.active = False
            self.ok = self.stretch.read()
            self.excluded_ns += time.perf_counter_ns() - self._t0
        elif not self.active and self.attempts < 3 and elapsed_ns >= self.window_ns // 3:
            self._t0 = time.perf_counter_ns()
            self.stretch, self.count, self.least, self.active = trace.Stretch(), 0, 0.0, True
            self.attempts += 1
            self.stretch.start()

    def record(self, spans, least: float) -> bool:
        """Record a finished unit's host spans and least time on the card
        (``benchmark/work.py``) if it ran inside the stretch."""
        if not self.active:
            return False
        self.count += 1
        self.least += least
        for name, t0, t1 in spans:
            self.stretch.span(name, t0, t1)
        return True

    def close(self):
        """At the window's end: a stretch still open is dropped."""
        if self.active:
            self.stretch.stop()
            self.active = False
            self.excluded_ns += time.perf_counter_ns() - self._t0

    def result(self):
        if self.on and not self.ok:
            raise RuntimeError(f"no traced stretch with device events after {self.attempts} "
                               "attempts")
        return self.stretch if self.ok else None
