"""The rank processes of tests/test_torch_dp.py, and the one-process runs
they are held against.

    python tests/torch_dp_ranks.py RANK WORLD PORT OUT_DIR

starts the gloo process group of ``WORLD`` CPU ranks at
``tcp://127.0.0.1:PORT`` (``parallel/dist.py:init``), runs every scenario
of ``SCENARIOS`` with this rank's ``DataParallel`` and writes their results
to ``OUT_DIR/rank<RANK>.pt``. The same functions with ``dp=None`` are the
one-process runs at the same global batch. Imports torch and the port only.

The config is tests/test_pallas_dp.py's: s=3, widths (8, 12, 16), the VAE's
latent 24, global batch 8, the default optimiser settings.
"""

from __future__ import annotations

import sys
import unittest.mock as mock

import numpy as np
import torch

from geniconet_tpu_torch import Config, bridge
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches
from geniconet_tpu_torch.nn import models
from geniconet_tpu_torch.nn.layers import DownBlock, UpBlock
from geniconet_tpu_torch.parallel import dist
from geniconet_tpu_torch.train.trainer import Trainer

S, WIDTHS, LATENT, B = 3, (8, 12, 16), 24, 8


def config(model: str) -> Config:
    cfg = Config()
    cfg.model.name = model
    cfg.model.subdivisions, cfg.model.widths, cfg.model.latent_features = S, WIDTHS, LATENT
    cfg.train.batch_size = B
    cfg.train.log_grad_freq = 0
    return cfg


def variables(model: str) -> dict:
    """The AE's seeded weights; the VAE's of a seed whose reconstruction at
    init has no near-zero vertex normal (3 seeds in 8 here give one, and the
    normal term's gradient, through 1/|n|, then reaches 1e6-1e8, where
    float32 rounding moves it by tens of percent: tests/test_torch_vae.py's
    seeds are chosen the same way, and the test asserts the regime)."""
    seed = 1 if model.endswith("_vae") else 5
    return bridge.init_variables(S, WIDTHS, seed=seed, model=model, latent_features=LATENT)


def batch(dp, seed=0):
    """This rank's slice (the whole batch without ``dp``) of the one global
    batch of 8 synthetic meshes."""
    ds = synthetic_dataset(S, B, seed=seed)
    shard = {} if dp is None else dict(rank=dp.rank, world=dp.world)
    return next(iter(Batches(ds, B, shuffle=False, device="cpu", **shard).epoch()))


def state_bits(dp, tensors) -> torch.Tensor:
    """(world, n) int32: each rank's float32 tensors flattened into one row
    as raw bits (``DataParallel.gather``), to show the ranks hold the same
    values bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return dp.gather(flat.view(torch.int32)[None])


def steps(dp, model="ico2ico", n=2, **routing):
    """``n`` train steps of the Trainer (the default route, or the
    ``routing`` options) on the batch, then eval: the metrics, the eval
    metrics and count, the variables, and under ``dp`` every rank's state
    bits (``state_bits``)."""
    tr = Trainer(config(model), device="cpu", dp=dp, **routing)
    st = tr.init_state(variables(model), seed=3)
    x, y, wt = batch(dp)
    out = {"steps": [{k: float(v) for k, v in tr.train_step(st, x, y, wt).items()}
                     for _ in range(n)]}
    ev, cnt = tr.eval_step(x, y, wt)
    out.update(eval={k: float(v) for k, v in ev.items()}, count=float(cnt),
               variables=tr.variables(),
               merged=[m.merged_block for m in tr.model.modules()
                       if isinstance(m, (DownBlock, UpBlock))])
    if tr.last_misc is not None:
        out["misc"] = [t.numpy().copy() for t in tr.last_misc]
    if dp is not None:
        out["bits"] = state_bits(dp, tr.model.state_dict().values()).numpy()
    return out


def injected_eps(mu):
    """Fixed eps of the global batch for a VAE latent shaped as ``mu`` (B/world rows)."""
    return np.random.RandomState(11).randn(B, *mu.shape[1:]).astype(np.float32)


def vae_steps(dp):
    """The VAE: the first draws of this rank's generator, then two steps and
    eval with eps injected (the global batch's fixed eps, this rank's rows)."""
    tr = Trainer(config("ico2ico_vae"), device="cpu", dp=dp)
    tr.init_state(variables("ico2ico_vae"), seed=3)
    draws = torch.randn(6, generator=tr.generator).numpy()
    part = slice(None) if dp is None else dist.shard_slice(B, dp.rank, dp.world)

    def reparameterize(mu, logvar, generator=None):
        eps = torch.from_numpy(injected_eps(mu)[part]).to(mu.dtype)
        return eps * torch.exp(0.5 * logvar) + mu

    with mock.patch.object(models, "reparameterize", reparameterize):
        out = steps(dp, "ico2ico_vae")
    return {"draws": draws, **out}


def bn_moments_grad(dp, own_cotangent=False, world=2):
    """Float64: the gradient of a BatchNorm-shaped loss of x (8, 5) through
    the global batch's moments, ``all_reduce_mean`` of the stacked local
    [mean, mean²] under ``dp``; this rank's rows of the gradient. Without
    ``dp``, one process over the whole batch; with ``own_cotangent`` every
    row of the gradient that ``world`` ranks would take if the backward did
    not all-reduce the moments' cotangent: each slice's loss through the
    global moments, the other slices' moments held constant."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(B, 5, generator=g, dtype=torch.float64) * 2 + 0.5
    w, c = torch.randn(5, generator=g, dtype=torch.float64), torch.rand(B, generator=g,
                                                                        dtype=torch.float64)

    def moments(x):
        return torch.stack([x.mean(0), (x * x).mean(0)])

    def loss(x, m, part):
        y = (x - m[0]) / torch.sqrt(m[1] - m[0] ** 2 + 1e-5) * w
        return (((y * y).sum(1) + y.sum(1)) * c[part]).sum()

    if dp is None and own_cotangent:
        parts = [dist.shard_slice(B, r, world) for r in range(world)]
        xs = [X[p].clone().requires_grad_() for p in parts]
        ms = [moments(x) for x in xs]
        for r, (x, part) in enumerate(zip(xs, parts)):
            m = sum(v if k == r else v.detach() for k, v in enumerate(ms)) / world
            loss(x, m, part).backward()
        return np.concatenate([x.grad.numpy() for x in xs])
    part = slice(None) if dp is None else dist.shard_slice(B, dp.rank, dp.world)
    x = X[part].clone().requires_grad_()
    m = moments(x) if dp is None else dist.all_reduce_mean(moments(x), dp)
    loss(x, m, part).backward()
    return x.grad.numpy()


# the routings whose backward folds the stats cotangent somewhere else:
# outside the kernels (the encoder's chain with JAX's fold set, kernel l)
# and inside kernel n (the decoder's chain)
FOLD_ROUTES = {"fold outside": dict(phase_chain="enc", kernel_geff=""),
               "decoder chain": dict(phase_chain="dec")}

SCENARIOS = {
    "ae": steps,
    "merged_block": lambda dp: steps(dp, merged_block="all", n=1),
    **{name: (lambda dp, r=r: steps(dp, **r)) for name, r in FOLD_ROUTES.items()},
    "vae": vae_steps,
    "bn_grad": bn_moments_grad,
}


def main(rank: int, world: int, port: int, out_dir: str):
    torch.set_num_threads(2)
    dp = dist.init(device_type="cpu", rank=rank, world=world,
                   init_method=f"tcp://127.0.0.1:{port}", timeout_s=120)
    try:
        results = {"dp": str(dp), **{k: fn(dp) for k, fn in SCENARIOS.items()}}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
