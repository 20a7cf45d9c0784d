"""The AE and VAE training step on one device.

Port of the single-device path of ``geniconet_tpu/train/trainer.py``:
``Trainer._loss`` (trainer.py:363-418) and ``Trainer._train_step``
(trainer.py:467-498): loss and gradients, Adam (``optax.adam`` with the
cyclic LR evaluated at the number of updates made so far, so the first
update uses ``lr_base``), the BatchNorm running statistics the forward
updated, and the metrics total / mse / cos / lap (the VAE's also recon /
kld) / lr / finite / grad_norm. The loss takes one of three branches:

* the VAE (``ico2ico_vae``): ``IcoVAE`` in train mode with eps drawn from
  the trainer's ``torch.Generator`` (seeded ``seed + 2`` by ``init_state``,
  as the JAX state's PRNG key; the two never share samples), then
  ``p2pkld_loss`` with the epoch's KL factor; ``last_misc`` keeps the
  batch's (mu, logvar);
* the AE with position-only factors: the decoder returns the per-sample
  position SSE against the packed target (the fused head+MSE kernel), so
  the reconstruction never reaches device memory;
* the AE with normal or Laplacian factors: the model's reconstruction,
  then ``p2p_loss``.

The models are the JAX defaults, ``pallas_blocks=None``: every block on the
kernels, forward with BatchNorm sums and hand-written backward; with
``merged_bwd`` (the JAX package's ``GENICONET_MERGED_BWD``, here a
constructor argument) the backward of the named kernel families runs on
the merged one-pass kernels; ``kernel_geff`` (``GENICONET_KERNEL_GEFF``)
picks the families whose split backward folds the stats cotangent inside
its kernels, the rest folding it before them (kernel l); ``phase_chain``
(``GENICONET_PHASE_CHAIN``) runs the encoder ("enc": kernel m), the
decoder ("dec": kernel n) or both ("1") as the phase chain;
``merged_block`` (``GENICONET_MERGED_BLOCK``) runs the named blocks'
forward as one kernel each (o, p). The JAX
package's TPU workarounds for the VAE at batch 24 and more (its split step
and ``pallas_blocks`` default) are not ported.

Data parallelism (``dp``, a ``parallel/dist.py:DataParallel``): the JAX
``shard_map`` step (trainer.py:431-465, 1034-1060). Each rank takes its
slice of the global batch (``data/pipeline.py:Batches``), normalises its
loss by the global weight sum (an all-reduce of Σwt before the forward),
and the models' BatchNorms average their moments over the ranks; then one
all-reduce sums the gradients, the loss and the metrics as one flat bucket
(a sum, not a mean: each rank's share is already over the global count),
and the grad norm and Adam follow on every rank, which therefore holds the
same parameters (``init_state`` broadcasts rank 0's). ``eval_step`` sums
the metrics and the weight sum the same way. The VAE's generator is folded
by rank, so each rank draws eps of its own, and ``last_misc`` is gathered
to the global batch. Rank 0 alone logs, profiles and writes checkpoints;
every rank restores the same file. The merged blocks (o, p) take the split
pair under data parallelism, as in JAX (their in-kernel affine would take
one rank's moments).

The epoch loop is the JAX ``Trainer``'s (trainer.py:1197-1449, reference
run.py:412-497): ``train_epoch`` syncs the metrics to the host every
``log_freq`` global steps, which doubles as the finite-loss guard, and logs
per-parameter grad norms every ``log_grad_freq``; ``validate`` sums the
weighted eval metrics on the device and syncs once; ``fit`` saves an EB
checkpoint whenever the validation loss is at or below the best (then the
GC), an E checkpoint every ``save_epoch_freq`` epochs and one at the end;
``restore`` reads a checkpoint of either package. The VAE's eval eps come
from a generator seeded afresh for every ``validate`` (the JAX package
draws them from one fixed key), so validation repeats and leaves the
training stream alone.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from geniconet_tpu_torch import device as devices
from geniconet_tpu_torch import tracing
from geniconet_tpu_torch.bridge import (
    adam_state_from_flax, adam_state_to_flax, flax_path, flax_to_state_dict, init_variables,
    state_dict_to_flax,
)
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.losses.p2p import (
    _wmean, kl_factor_at_epoch, loss_factors, p2p_loss, p2pkld_loss,
)
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE, reparameterize
from geniconet_tpu_torch.ops.vertices import grid_to_vertices, pack_target_phases
from geniconet_tpu_torch.parallel.dist import DataParallel
from geniconet_tpu_torch.train import checkpoint as ckpt
from geniconet_tpu_torch.train.schedule import cyclic_triangular

__all__ = ["TrainState", "Trainer", "fresh_variables"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_EVAL_STREAM = 0x7FFFFFFF  # offset of the eval generator's seed (JAX folds this into its key)


def _to_host(values: dict) -> dict:
    """{name: 0-d tensor or number} -> {name: float}, with one device sync
    (the span ``sync``)."""
    keys = [k for k, v in values.items() if torch.is_tensor(v)]
    out = {k: float(v) for k, v in values.items() if not torch.is_tensor(v)}
    if keys:
        with tracing.span("sync"):
            host = torch.stack([values[k].detach().float() for k in keys]).cpu().tolist()
        out.update(zip(keys, host))
    return {k: out[k] for k in values}


def _sample_channels(v: np.ndarray, groups: int = 6) -> np.ndarray:
    """Channels-last (B, H, W, C) -> (B·6, H, W, 1) image stack, one channel
    out of each of six groups (reference run.py:203-211)."""
    step = max(1, v.shape[-1] // groups)
    imgs = v[..., list(range(0, v.shape[-1], step))[:groups]]
    return np.moveaxis(imgs, -1, 1).reshape(-1, v.shape[1], v.shape[2], 1)


def fresh_variables(cfg) -> dict:
    """The seeded variable tree a run of ``cfg``'s model starts from
    (``bridge.init_variables`` with ``cfg.train.seed``)."""
    m = cfg.model
    return init_variables(m.subdivisions, tuple(m.widths), seed=cfg.train.seed, model=m.name,
                          latent_features=m.latent_features)


@dataclass
class TrainState:
    optimizer: torch.optim.Adam
    step: int = 0  # updates made so far; drives the cyclic LR


class Trainer:
    """Owns the model and runs the train step, on the card unless
    ``device="cpu"``. ``merged_bwd``: None, "all" or a comma list of
    kernel families (``ops/kernels/fused.py:merged_bwd_enabled``); ``phase_chain``:
    None, "0", "enc", "dec" or "1"; ``kernel_geff``: None (every family
    folds in-kernel) or a ``GENICONET_KERNEL_GEFF`` value
    (``nn/layers.py:kernel_geff_enabled``); ``merged_block``: None, "all"
    or a comma list of block names (``nn/layers.py:merged_block_enabled``);
    ``logger``: a ``train/logging.py:Logger``, or None to log nothing;
    ``dp``: this rank of a data-parallel run (module doc), which then runs
    on ``dp.device`` whatever ``device`` says, or None."""

    def __init__(self, cfg, device="cuda", merged_bwd: str | None = None,
                 phase_chain: str | None = None, kernel_geff: str | None = None,
                 merged_block: str | None = None, logger=None, dp: DataParallel | None = None):
        m = cfg.model
        self.dp = dp
        self.main = dp is None or dp.rank == 0  # the rank that logs and saves
        self.cfg, self.s = cfg, m.subdivisions
        self.device = devices.resolve(device if dp is None else dp.device)
        self.is_vae = m.is_vae
        self.factors = loss_factors(cfg)
        self.fused_mse = not self.is_vae and self.factors.nor == 0.0 and self.factors.lap == 0.0
        dtype = _DTYPES[m.compute_dtype]
        routing = dict(merged_bwd=merged_bwd, phase_chain=phase_chain, kernel_geff=kernel_geff,
                       merged_block=merged_block, device=self.device, dp=dp)
        if dp is not None and merged_block not in (None, "", "0") and self.main:
            print(f"[train] data parallel: merged_block={merged_block!r} runs each block's "
                  "split pair (the merged kernels' BatchNorm affine would take one rank's "
                  "moments)")
        if self.is_vae:
            self.model = IcoVAE(m.subdivisions, tuple(m.widths), m.latent_features,
                                m.corner_mode, dtype, **routing)
        else:
            self.model = IcoAE(m.subdivisions, tuple(m.widths), m.corner_mode, dtype, **routing)
        o = cfg.optim
        self.lr_fn = partial(cyclic_triangular, base_lr=o.lr_base, max_lr=o.lr_max,
                             step_size_up=o.step_size_up, step_size_down=o.step_size_down)
        self.logger = logger if self.main else None
        self.seed = 0  # init_state's
        self.generator = None  # the VAE's eps, from init_state
        self.last_misc = None  # the VAE's last (mu, logvar), reference run.py:274-277
        self._host_step = 0  # updates made, mirrored on the host for the log cadence

    def init_state(self, variables, seed: int = 0) -> TrainState:
        """Load a flax-layout variable tree (``bridge``), seed the VAE's
        sampling generator (folded by rank under data parallelism) and
        start Adam. Under data parallelism every rank then holds rank 0's
        variables."""
        sd = flax_to_state_dict(variables)
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        if self.dp is not None:
            self.dp.broadcast_(self.model.state_dict().values())
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(self._fold(seed + 2))
        o = self.cfg.optim
        return TrainState(torch.optim.Adam(self.model.parameters(), lr=self.lr_fn(0),
                                           betas=(o.b1, o.b2), eps=o.eps))

    def variables(self) -> dict:
        """The model's parameters and BatchNorm statistics as a flax tree."""
        return state_dict_to_flax(self.model.state_dict())

    def _fold(self, seed: int) -> int:
        """A generator seed of this rank (``DataParallel.fold_seed``)."""
        return seed if self.dp is None else self.dp.fold_seed(seed)

    def _global_wsum(self, wt):
        """Under data parallelism the global batch's weight sum (JAX's
        ``psum(Σwt)``), the normaliser of every rank's loss; else None."""
        if self.dp is None:
            return None
        wsum = wt.float().sum()
        self.dp.sum_([wsum])
        return wsum

    def loss(self, x, y, wt, train: bool = True, epoch: int = 0, generator=None, wsum=None):
        """(loss, metrics) of one batch: x (B, H, W, 3) grids, y (B, V, 9)
        targets, wt (B,) sample weights; ``epoch`` sets the VAE's KL factor,
        whose eps come from ``generator`` (default: the trainer's);
        ``wsum``: the normaliser of the weighted means (None: this batch's
        max(Σwt, 1); the global Σwt under data parallelism). The model's
        call runs in the span ``forward``, the rest in ``loss``."""
        if self.is_vae:
            gen = self.generator if generator is None else generator
            with tracing.span("forward"):
                recon, mu, logvar = self.model(x, train=train, sample=True, generator=gen)
            with tracing.span("loss"):
                t = self.cfg.train
                kf = kl_factor_at_epoch(epoch, step_size=t.factor_step_size, gamma=t.factor_gamma)
                if train:
                    self.last_misc = self._global_misc(mu, logvar)
                return p2pkld_loss(recon, mu, logvar, y, self.s, self.factors, kf, wt, wsum)
        if not self.fused_mse:
            with tracing.span("forward"):
                recon = self.model(x, train=train)
            with tracing.span("loss"):
                return p2p_loss(recon, y, self.s, self.factors, wt, wsum)
        with tracing.span("loss"):
            tpack, tpoles = pack_target_phases(y, self.s)
        with tracing.span("forward"):
            sse = self.model.recon_sse(x, tpack, tpoles, train=train)
        with tracing.span("loss"):
            l_pos = _wmean(sse / (ico.num_vertices(self.s) * 3.0), wt, wsum)
            zero = torch.zeros((), device=l_pos.device)
            return self.factors.pos * l_pos, {"mse": l_pos.detach(), "cos": zero, "lap": zero}

    def _global_misc(self, mu, logvar):
        """The VAE's (mu, logvar) of the global batch (JAX's ``misc_spec``):
        under data parallelism gathered from every rank in one all-reduce."""
        mu, logvar = mu.detach(), logvar.detach()
        if self.dp is None:
            return mu, logvar
        both = self.dp.gather(torch.cat([mu, logvar], dim=-1))
        return both[..., : mu.shape[-1]], both[..., mu.shape[-1]:]

    def _sum_over_ranks(self, loss, metrics, grads=()):
        """Under data parallelism, the JAX step's psum: the gradients, the
        loss and the metrics summed over the ranks in one all-reduce, in
        place of their local values. Returns (loss, metrics)."""
        if self.dp is None:
            return loss, metrics
        keys = list(metrics)
        vals = [loss.detach().float().clone()] + [metrics[k].detach().float().clone()
                                                  for k in keys]
        self.dp.sum_([*grads, *vals])
        return vals[0], dict(zip(keys, vals[1:]))

    def _update(self, state: TrainState, x, y, wt, epoch: int):
        """One update: (metrics, [(state_dict key, grad norm)] of every
        parameter with a gradient). Spans: ``backward``; ``update`` with
        ``grad_norm`` and ``optimizer``."""
        lr = self.lr_fn(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, y, wt, train=True, epoch=epoch, wsum=self._global_wsum(wt))
        with tracing.span("backward"):
            loss.backward()
        loss, metrics = self._sum_over_ranks(
            loss, metrics, [p.grad for p in self.model.parameters() if p.grad is not None])
        with tracing.span("update"):
            with tracing.span("grad_norm"):
                norms = [(k, torch.linalg.vector_norm(p.grad))
                         for k, p in self.model.named_parameters() if p.grad is not None]
                grad_norm = torch.linalg.vector_norm(torch.stack([n for _, n in norms]))
            with tracing.span("optimizer"):
                for group in state.optimizer.param_groups:
                    group["lr"] = lr
                state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(total=loss.detach(), lr=lr, finite=torch.isfinite(loss.detach()),
                       grad_norm=grad_norm)
        return metrics, norms

    def train_step(self, state: TrainState, x, y, wt, epoch: int = 0) -> dict:
        """One update; returns the metrics as 0-d tensors (lr a float)."""
        return self._update(state, x, y, wt, epoch)[0]

    @torch.no_grad()
    def eval_step(self, x, y, wt, epoch: int = 0, generator=None):
        """Eval-mode metrics of one batch (``total`` among them, weighted
        means as 0-d tensors) and the batch's weight sum; under data
        parallelism the global batch's, summed over the ranks."""
        wsum = self._global_wsum(wt)
        loss, metrics = self.loss(x, y, wt, train=False, epoch=epoch, generator=generator,
                                  wsum=wsum)
        loss, metrics = self._sum_over_ranks(loss, metrics)
        return {**metrics, "total": loss}, wt.sum() if wsum is None else wsum

    # ------------------------------------------------------------------
    # epoch loops (JAX trainer.py:1197-1349, reference run.py:412-497)
    # ------------------------------------------------------------------

    def train_epoch(self, state: TrainState, batches, epoch: int):
        """One pass over ``batches`` (a ``data/pipeline.py:Batches``), each
        step in the span ``step``. Returns (state, info): ``iters``,
        ``last`` (the last metrics synced to the host, None if the cadence
        skipped every step) and ``last_device`` (the last step's metrics as
        tensors). With ``debug_timing`` it prints the epoch's wall time a
        step, the device drained at both ends."""
        debug = self.cfg.train.debug_timing
        if debug:
            self._sync()
        t0 = time.perf_counter()
        n, last, metrics = 0, None, None
        log_freq = max(1, self.cfg.train.log_freq)
        gf_freq = self.cfg.train.log_grad_freq
        for i, (x, y, wt) in enumerate(batches.epoch()):
            with tracing.unit("step"):
                want_gflow = self.logger is not None and gf_freq and self._host_step % gf_freq == 0
                metrics, norms = self._update(state, x, y, wt, epoch)
                self._host_step += 1
                n += 1
                if (self._host_step - 1) % log_freq == 0:
                    # cadenced by the global step: the periodic sync doubles as
                    # the NaN guard (reference run.py:237), logger or not
                    last = _to_host(metrics)
                    if not last["finite"]:
                        raise FloatingPointError(
                            f"non-finite loss at epoch {epoch} iter {i}: {last}")
                    if self.logger is not None:
                        self.logger.scalars("trn", last, state.step)
                if want_gflow:
                    # per-parameter grad norms under the JAX names (reference run.py:264-267)
                    gflow = {"/".join(flax_path(k)[1]): v for k, v in norms}
                    self.logger.scalars("grad_flow", _to_host(gflow), state.step)
        if debug:
            self._sync()
            dt = time.perf_counter() - t0
            print(f"[debug] epoch {epoch}: {n} iters in {dt:.2f}s "
                  f"({dt / max(n, 1) * 1000:.1f} ms/iter)")
        return state, {"iters": n, "last": last, "last_device": metrics}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def validate(self, state: TrainState, batches, epoch: int) -> dict:
        """Weighted means of the eval metrics over ``batches``, summed on the
        device with one host sync at the end."""
        gen = None
        if self.is_vae:
            gen = torch.Generator(device=self.device).manual_seed(
                self._fold(self.seed + 2 + _EVAL_STREAM))
        total, count = None, None
        for x, y, wt in batches.epoch():
            metrics, b = self.eval_step(x, y, wt, epoch, generator=gen)
            scaled = {k: v * b for k, v in metrics.items()}
            total = scaled if total is None else {k: total[k] + scaled[k] for k in scaled}
            count = b if count is None else count + b
        if total is None:
            return {}
        host = _to_host({**total, "__count": count})
        c = max(host.pop("__count"), 1.0)
        avg = {k: v / c for k, v in host.items()}
        if self.logger is not None and avg:
            self.logger.scalars("val", avg, state.step)
        return avg

    def fit(self, state: TrainState, trn, val, start_epoch: int = 0, best_loss: float = math.inf):
        """Epochs ``start_epoch`` to ``train_epoch``: log meshes and
        encodings on their cadence, train, validate, save. Returns (state,
        the validation totals)."""
        cfg = self.cfg
        name = cfg.model.name
        ckpt_dir = os.path.join(cfg.model_log_dir(), "savedModel")
        history = []
        for epoch in range(start_epoch, cfg.train.train_epoch):
            if self.logger is not None and cfg.train.log_mesh_epoch and \
                    epoch % cfg.train.log_mesh_epoch == 0:
                self._log_meshes(state, val, epoch)
            if self.logger is not None and cfg.train.log_encoding_epoch and \
                    epoch % cfg.train.log_encoding_epoch == 0 and epoch > 0:  # run.py:193-194
                self._log_encoding(state, val, epoch)
            with self._profiled(epoch == start_epoch + 1, epoch):
                state, _ = self.train_epoch(state, trn, epoch)
            # validate with the KL factor the epoch trained with: the
            # reference decays it only after validation (run.py:486-493)
            cur = self.validate(state, val, epoch).get("total", math.inf)
            history.append(cur)
            # every rank takes these branches alike (cur is the ranks' sum);
            # rank 0 alone writes
            if cur <= best_loss:  # the reference saves on ties too (run.py:318)
                best_loss = cur
                self._save(state, ckpt_dir, name, epoch + 1, cur, best=True, best_loss=best_loss)
                if self.main:
                    ckpt.gc_best_checkpoints(ckpt_dir, name)
            if (epoch + 1) % cfg.train.save_epoch_freq == 0:
                self._save(state, ckpt_dir, name, epoch + 1, cur, best=False, best_loss=best_loss)
        if cfg.train.train_epoch > start_epoch:
            self._save(state, ckpt_dir, name, cfg.train.train_epoch,
                       history[-1] if history else math.inf, best=False, best_loss=best_loss)
        if self.dp is not None:
            self.dp.barrier()  # the files are written before any rank goes on
        return state, history

    @contextlib.contextmanager
    def _profiled(self, on: bool, epoch: int):
        """A ``torch.profiler`` trace of the block into ``profile_dir`` when
        ``on`` and the directory is set (rank 0 only), else nothing. The
        program's spans (``tracing``) are recorded meanwhile and written into
        the trace as the process "program spans", placed on the trace's
        clock by a clock mark at each end."""
        out = self.cfg.train.profile_dir
        if not (on and out and self.main):
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            marks = [tracing.clock_mark("geniconet_tpu_torch.clock.start")]
            tracing.start()
            try:
                yield
            finally:
                records = tracing.stop()
                marks.append(tracing.clock_mark("geniconet_tpu_torch.clock.end"))
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"epoch{epoch}.trace.json")
        prof.export_chrome_trace(path)
        offsets = tracing.add_to_chrome_trace(path, records, marks)
        found = " / ".join(f"{o:.1f} ± {e:.1f}" for o, e in offsets) or "no clock mark"
        print(f"[profile] {path}: {len(records)} program spans; trace minus host clock "
              f"at the marks {found} µs")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _save(self, state: TrainState, ckpt_dir: str, name: str, epoch: int, loss: float,
              best: bool, best_loss: float | None = None):
        """Write the JAX package's checkpoint tree: params, batch_stats,
        optax's Adam state, step, epoch, loss, the running best (so a resume
        from a periodic save keeps protecting the best EB file) and the
        VAE's last (mu, logvar) as ``misc``; on rank 0 only."""
        if not self.main:
            return
        blob = {**self.variables(),
                "opt_state": adam_state_to_flax(state.optimizer, self.model.named_parameters(),
                                                state.step),
                "step": int(state.step), "epoch": int(epoch), "loss": float(loss),
                "best_loss": float(loss if best_loss is None else best_loss)}
        if self.last_misc is not None:
            mu, logvar = (t.float().cpu().numpy() for t in self.last_misc)
            blob["misc"] = {"trn_mean": mu, "trn_logvar": logvar}
        ckpt.save_checkpoint(ckpt.checkpoint_path(ckpt_dir, name, epoch, best), blob)

    def restore(self, state: TrainState, path: str):
        """Load a checkpoint of either package into the model and ``state``'s
        optimizer. Returns (state, epoch, best_loss); best_loss feeds
        ``fit`` so a resumed run keeps the true best (reference run.py:374-376)."""
        blob = ckpt.load_checkpoint(path)
        sd = flax_to_state_dict({"params": blob["params"], "batch_stats": blob["batch_stats"]})
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        adam_state_from_flax(blob["opt_state"], state.optimizer, self.model.named_parameters())
        state.step = self._host_step = int(blob["step"])
        best = float(blob.get("best_loss", blob.get("loss", math.inf)))
        return state, int(blob["epoch"]), best

    # ------------------------------------------------------------------
    # logging (never raises, as in JAX)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _log_encoding(self, state: TrainState, val, epoch: int, k: int = 3):
        """The encodings of a fixed validation subset (reference
        run.py:167-215): the AE's bottleneck of the first ``k`` samples,
        tagged with the model name; the VAE's mu, logvar and a
        reparameterised z of the first. Histograms, or with
        ``log_encoding_hist`` False channel images."""
        try:
            name, hist = self.cfg.model.name, self.cfg.train.log_encoding_hist
            if self.is_vae:
                x = torch.as_tensor(val.ds.inputs[:1], device=self.device)
                mu, logvar = self.model.encode(x)
                gen = torch.Generator(device=self.device).manual_seed(self.seed + 2 + epoch)
                z = reparameterize(mu, logvar, gen)
                tagged = [(tag, v.float().cpu().numpy())
                          for tag, v in (("mu", mu), ("logvar", logvar), ("reparam", z))]
            else:
                x = torch.as_tensor(val.ds.inputs[:k], device=self.device)
                z = self.model.encode(x).float().cpu().numpy()
                tagged = [(name, z)] if hist else [(f"{name}_{i}", z[i : i + 1])
                                                   for i in range(z.shape[0])]
            for tag, v in tagged:
                if hist:
                    self.logger.histogram(tag, v, state.step)
                else:
                    self.logger.images(tag, _sample_channels(v), state.step)
        except Exception as e:  # logging must never stop training
            print(f"[log_encoding] skipped: {e!r}")

    @torch.no_grad()
    def _log_meshes(self, state: TrainState, val, epoch: int, k: int = 3):
        """The first ``k`` validation meshes' reconstructions, coloured by
        their distance to the target (reference run.py:97-148)."""
        try:
            x = torch.as_tensor(val.ds.inputs[:k], device=self.device)
            recon = self.model(x, train=False, sample=False)[0] if self.is_vae else self.model(x)
            v = grid_to_vertices(recon, self.s).float().cpu().numpy()
            self.logger.meshes("val_recon", v, val.ds.targets[:k, :, :3], self.s, epoch)
        except Exception as e:  # logging must never stop training
            print(f"[log_mesh] skipped: {e!r}")
