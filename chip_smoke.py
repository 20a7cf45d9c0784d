#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA GPU and check them.

    python3 chip_smoke.py

Eighteen paths at full width (s=5, widths 64/128/256; the VAE's latent
512): AE serving, AE training, VAE serving, VAE training, AE and VAE
training on the merged backward route (``merged_bwd="all"``); the encoder's
phase chain (``phase_chain="enc"``: kernel m): AE serving, AE and VAE
training, AE training on the merged route, and AE training with the stats
fold outside the kernels (``kernel_geff=""``, JAX's built-in fold set:
kernel l); both halves chained (``phase_chain="1"``: m and the decoder's
kernel n): AE and VAE serving, AE and VAE training, AE training on the
merged route and with every fold outside (``kernel_geff="0"``); and AE
training on the decoder's chain alone (``phase_chain="dec"``). Phases, each
printed on its own lines, each fatal on failure:

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``geniconet_tpu_torch/csrc/*.cu`` (sm_90a; one nvcc per
   source, all started together, then one link);
3. kernel vs plain, serving: each of the four forward kernels against its
   plain PyTorch version at the shapes the AE and VAE serving paths give it
   (B=16), in float32 (TF32 off) and bfloat16, with the error against the
   stated tolerance and the median CUDA-event time of both;
4. kernel vs plain, training: the forward kernels' BatchNorm stats and the
   nine backward and loss kernels (phase-conv, up-conv and standard-conv
   dx and dtaps, with the stats fold; the head's backward; the head+MSE
   forward and backward) at the shapes of AE and VAE training at B=36
   (the DownBlocks' and the VAE heads' stride-2 convs with and without an
   act prologue), the same way. Every case also prints its bound (the
   least time the card could take: bytes over 3.35 TB/s or FLOPs over the
   peak for the dtype, whichever is larger) and, for the convs, the time of
   the one cuDNN call that does the same contraction on an input already
   haloed (upsampled, for the up conv), which the port never calls. The
   three merged backward kernels (i, j, k) also print the time of the
   split pair they replace at the same shape (its dx call, with the Σg
   pass, and its dtaps call, each timed alone: they run the merged
   kernel's two tile roles on their own) and cuDNN's dx + dweight; kernel
   m (``ds2s_*``) at the chain's DownBlock shapes and l (``stats_geff``)
   at each group it folds on the chain, with the phase conv's kernels at
   the chain's conv01 shapes; l at down0 also prints what the fold costs
   inside m's dx + dtaps (those two with and without it). l's time comes
   from a ``torch.profiler`` trace: CUDA events around a call that short
   measure its wrapper's host time; n (``up_pair_*``) at up1 and up2, its
   forward at the serving and the training batch, its dx and dtaps with
   the fold in the kernels and without;
5. serving: ``AppState.load`` of an AE and of a VAE on 32 synthetic meshes
   with seeded random weights (non-trivial BN statistics), then
   ``handle_api`` requests (the VAE's ``/api/regenerate`` too), in bfloat16
   and float32; every mesh must have 10,242 finite vertices, every serving
   kernel must have launched on each path, and two float32 decodes must
   match the same model run through the plain route on the CPU; then the
   AE on the encoder's chain, whose latent cache must match the unchained
   one, and the AE and the VAE on both chains, whose latent caches and
   decodes must;
6. timings: p50 single-mesh decode latency and encode+decode meshes/s at B=16;
7. training: the AE ``Trainer`` and the VAE ``Trainer`` (the default
   routing, every block on the kernels; the AE's loss from the head+MSE
   kernel, the VAE's from the head kernel and the P2P+KLD loss), each on
   the default backward route, the merged one (``merged_bwd="all"``) and
   the phase chains (``TRAIN_ROUTES``), take 6 Adam steps each at B=36 on
   64 synthetic meshes, in bfloat16 and float32; every loss must be finite,
   every kernel of each path must have launched and none that the path
   must not run (``PATH_FORBIDDEN``), n twice and the up conv once a
   forward on the decoder's chain, and training meshes/s is the median of
   the last 4 steps; then one float32 step of each model and routing at B=4 (the
   VAE's eps fixed) must match the same step on the CPU's plain route of
   the same chain setting (loss, every gradient, the new BatchNorm
   statistics), and each check must catch a 1% error planted in one kernel
   output at a time; then whole training steps of each model's routings
   (the AE's also ``pallas_blocks="up0,up1,up2"``, encoder and head on
   cuDNN), in turns at B=36 bfloat16, side by side (default, enc, dec,
   both chains, ...);
8. profile: where the device time goes in the timed serving workloads and
   in AE and VAE training steps on every training path (bfloat16), read
   from a ``torch.profiler``
   trace, with the device's idle share; the Chrome traces are kept in
   ``build/profile/``.

The line before the last is ``{"kernels": [...]}``, with each kernel's
launches on the serving and training paths (AE and VAE summed, and per
path), its bf16 time, its plain version's, its bound and the library
call's, summed over its shapes (a forward kernel's times are its serving
shapes', and ``training_shapes`` holds those of its training shapes;
``by_shapes`` splits each sum into the AE's shapes, the no-act stride-2
shapes, the VAE's new shapes and the chains'); the last is ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits with an error before
printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

import torch

SUBDIVISIONS = 5
WIDTHS = (64, 128, 256)
LATENT = 512  # the VAE's latent_features
BATCH = 16
N_MESHES = 32
TRAIN_BATCH = 36
TRAIN_MESHES = 64
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # times each output's max|ref|
TOL_WHY = {
    torch.float32: "only the order of the float32 sums differs",
    torch.bfloat16: "float32 sums round to bf16 at different points",
}
# Published dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 on the
# tensor cores, float32 on the CUDA cores, device memory bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
_ALL = (0, 1, 2, 3)
KERNELS = {
    "phase_conv_fwd": ("geniconet_tpu_torch/csrc/phase_conv.cu",
                       "geniconet_tpu/ops/pallas/phase_kernel.py:1272"),
    "up_dual_conv_fwd": ("geniconet_tpu_torch/csrc/up_conv.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:1999"),
    "pair_head_fwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:3241"),
    "ico_conv_s2s_fwd": ("geniconet_tpu_torch/csrc/ico_conv.cu",
                         "geniconet_tpu/ops/pallas/conv_kernel.py:253"),
    "phase_conv_dx": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:1336"),
    "phase_conv_dtaps": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:1406"),
    "up_dual_conv_dx": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                        "geniconet_tpu/ops/pallas/phase_kernel.py:2123"),
    "up_dual_conv_dtaps": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                           "geniconet_tpu/ops/pallas/phase_kernel.py:2150"),
    "ico_conv_s2s_dx": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                        "geniconet_tpu/ops/pallas/conv_kernel.py:727"),
    "ico_conv_s2s_dtaps": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                           "geniconet_tpu/ops/pallas/conv_kernel.py:665"),
    "pair_head_mse_fwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                          "geniconet_tpu/ops/pallas/phase_kernel.py:3528"),
    "pair_head_mse_bwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                          "geniconet_tpu/ops/pallas/phase_kernel.py:3577"),
    "pair_head_bwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:3287"),
    "phase_conv_bwd": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                       "geniconet_tpu/ops/pallas/phase_kernel.py:932"),
    "up_dual_conv_bwd": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:2068"),
    "ico_conv_s2s_bwd": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/conv_kernel.py:601"),
    "stats_geff": ("geniconet_tpu_torch/csrc/stats_geff.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:1462"),
    "ds2s_fwd": ("geniconet_tpu_torch/csrc/ds2s.cu",
                 "geniconet_tpu/ops/pallas/phase_kernel.py:1818"),
    "ds2s_dx": ("geniconet_tpu_torch/csrc/ds2s.cu",
                "geniconet_tpu/ops/pallas/phase_kernel.py:1895"),
    "ds2s_dtaps": ("geniconet_tpu_torch/csrc/ds2s.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:1936"),
    "up_pair_fwd": ("geniconet_tpu_torch/csrc/up_pair.cu",
                    "geniconet_tpu/ops/pallas/phase_kernel.py:2380"),
    "up_pair_dx": ("geniconet_tpu_torch/csrc/up_pair.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:2458"),
    "up_pair_dtaps": ("geniconet_tpu_torch/csrc/up_pair.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:2490"),
}
_FORWARD = ("phase_conv_fwd", "up_dual_conv_fwd", "pair_head_fwd", "ico_conv_s2s_fwd")
_BACKWARD = ("phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx", "up_dual_conv_dtaps",
             "ico_conv_s2s_dx", "ico_conv_s2s_dtaps")
# the merged route: i, j, k, and conv_in's dtaps (it has no input cotangent)
_MERGED = ("phase_conv_bwd", "up_dual_conv_bwd", "ico_conv_s2s_bwd", "phase_conv_dtaps")
_AE_HEAD = ("pair_head_mse_fwd", "pair_head_mse_bwd")
# the phase chain: m in place of the DownBlocks' stride-2 phase conv and
# standard conv01 (conv01 runs as the phase conv); l with the fold outside
_STD = ("ico_conv_s2s_fwd", "ico_conv_s2s_dx", "ico_conv_s2s_dtaps", "ico_conv_s2s_bwd")
_CHAIN = ("ds2s_fwd", "ds2s_dx", "ds2s_dtaps")
_CHAIN_FWD = ("phase_conv_fwd", "ds2s_fwd", "up_dual_conv_fwd")
_CHAIN_SPLIT = (*_CHAIN[1:], "phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx",
                "up_dual_conv_dtaps")
_N = ("up_pair_fwd", "up_pair_dx", "up_pair_dtaps")
_N_BWD = _N[1:]
# the kernels each path must launch: the AE's training loss runs the
# head+MSE pair (g, h), the VAE's the head and its backward (e)
PATH_KERNELS = {
    "AE serve": _FORWARD,
    "AE train": (*(k for k in _FORWARD if k != "pair_head_fwd"), *_BACKWARD, *_AE_HEAD),
    "AE train (merged)": (*(k for k in _FORWARD if k != "pair_head_fwd"), *_MERGED, *_AE_HEAD),
    "VAE serve": _FORWARD,
    "VAE train": (*_FORWARD, *_BACKWARD, "pair_head_bwd"),
    "VAE train (merged)": (*_FORWARD, *_MERGED, "pair_head_bwd"),
    "AE serve (chain)": (*_CHAIN_FWD, "pair_head_fwd"),
    "AE train (chain)": (*_CHAIN_FWD, *_CHAIN_SPLIT, *_AE_HEAD),
    "VAE train (chain)": (*_CHAIN_FWD, *_CHAIN_SPLIT, "pair_head_fwd", "pair_head_bwd"),
    "AE train (chain, merged)": (*_CHAIN_FWD, *_CHAIN[1:], *_MERGED[:2], "phase_conv_dtaps",
                                 *_AE_HEAD),
    "AE train (chain, fold outside)": (*_CHAIN_FWD, *_CHAIN_SPLIT, "stats_geff", *_AE_HEAD),
    # both chains: n at up1 and up2 (up0 keeps the up conv, which reads the latent grid)
    "AE serve (chain all)": (*_CHAIN_FWD, "up_pair_fwd", "pair_head_fwd"),
    "VAE serve (chain all)": (*_CHAIN_FWD, "up_pair_fwd", "pair_head_fwd"),
    "AE train (chain all)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD, *_AE_HEAD),
    "VAE train (chain all)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD,
                              "pair_head_fwd", "pair_head_bwd"),
    "AE train (chain all, merged)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN[1:], *_MERGED[:2],
                                     "phase_conv_dtaps", *_N_BWD, *_AE_HEAD),
    "AE train (chain all, fold outside)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD,
                                           "stats_geff", *_AE_HEAD),
    "AE train (chain dec)": (*(k for k in _FORWARD if k != "pair_head_fwd"), "up_pair_fwd",
                             *_BACKWARD, *_N_BWD, *_AE_HEAD),
}
# ... and the kernels it must not launch: each backward route runs none of
# the other's conv backward kernels, the default paths neither l nor m, the
# encoder's chain none of the standard conv's, no path without the
# decoder's chain n, and the decoder's chain no merged up conv at up1-2
_SPLIT_ONLY = tuple(k for k in _BACKWARD if k != "phase_conv_dtaps")
_NEW = ("stats_geff", *_CHAIN, *_N)
PATH_FORBIDDEN = {
    "AE serve": _NEW, "VAE serve": _NEW,
    "AE train": (*_MERGED[:3], *_NEW), "VAE train": (*_MERGED[:3], *_NEW),
    "AE train (merged)": (*_SPLIT_ONLY, *_NEW), "VAE train (merged)": (*_SPLIT_ONLY, *_NEW),
    "AE serve (chain)": (*_STD, *_N),
    "AE train (chain)": (*_STD, *_MERGED[:2], "stats_geff", *_N),
    "VAE train (chain)": (*_STD, *_MERGED[:2], "stats_geff", *_N),
    "AE train (chain, merged)": (*_STD, *_SPLIT_ONLY, "stats_geff", *_N),
    "AE train (chain, fold outside)": (*_STD, *_MERGED[:2], *_N),
    "AE serve (chain all)": _STD, "VAE serve (chain all)": _STD,
    "AE train (chain all)": (*_STD, *_MERGED[:2], "stats_geff"),
    "VAE train (chain all)": (*_STD, *_MERGED[:2], "stats_geff"),
    "AE train (chain all, merged)": (*_STD, *_SPLIT_ONLY, "stats_geff"),
    "AE train (chain all, fold outside)": (*_STD, *_MERGED[:2]),
    "AE train (chain dec)": (*_MERGED[:3], *_NEW[:4]),
}
# the training routings, by path: (merged_bwd, phase_chain, kernel_geff)
ROUTES = {
    "": (None, None, None),
    " (merged)": ("all", None, None),
    " (chain)": (None, "enc", None),
    " (chain, merged)": ("all", "enc", None),
    " (chain, fold outside)": (None, "enc", ""),
    " (chain all)": (None, "1", None),
    " (chain all, merged)": ("all", "1", None),
    " (chain all, fold outside)": (None, "1", "0"),
    " (chain dec)": (None, "dec", None),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_ms(fn, reps: int = 20) -> float:
    """Device time of fn() in ms: the kernels' durations in a torch.profiler
    trace, per call. For a kernel shorter than its wrapper's host time, where
    CUDA events around one call measure the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = Path(__file__).resolve().parent / "build" / "profile" / "kernel_case.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    return sum(e["dur"] for e in events if e.get("cat") == "kernel") / 1e3 / reps


def _rnd(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _act(gen, c):
    return (torch.rand(c, generator=gen, device="cuda") + 0.5, _rnd(gen, c, scale=0.3))


def _taps(gen, cin, cout, dt):
    return _rnd(gen, 7, cin, cout, dtype=dt, scale=(7 * cin) ** -0.5), _rnd(gen, cout, dtype=dt)


def _pair_inputs(gen, B, h, w, cin, dt):
    """A level-s (h, w) grid's raw phase pair (4 + 4 phases (B, 5, h/2, w/2,
    C_in)) and its 4 float32 affines, as kernel n takes them."""
    ph = [_rnd(gen, B, 5, h // 2, w // 2, cin, dtype=dt) for _ in range(8)]
    return ph[:4], ph[4:], [*_act(gen, cin), *_act(gen, cin)]


class Case:
    """One kernel call at one shape: the kernel and its plain version, the
    FLOPs the function needs, its input tensors (each read once), where
    cuDNN computes the same contraction that call, for a merged backward
    kernel the split pair it replaces (its dx and its dtaps call), and
    other calls to time beside it (``compare``: label -> call). ``short``:
    the kernel is timed from a profiler trace (``trace_ms``)."""

    def __init__(self, kernel, plain, flops, inputs, library=None, split=None, compare=None,
                 short=False):
        self.kernel, self.plain, self.flops, self.library = kernel, plain, flops, library
        self.split, self.compare, self.short = split, compare or {}, short
        self.inputs = [t for t in flat(inputs) if t is not None]


def conv_flops(B, cells, cin, ntot):
    """2·rows·7·C_in·C_out of a hex conv whose outputs are B·cells rows of ntot channels."""
    return 2 * B * cells * 7 * cin * ntot


def cudnn(kind, gen, dt, n, cin, cout, hp, wp, stride=1):
    """The cuDNN call of one hex conv's contraction, on an input already
    haloed to (n, C_in, hp, wp), channels-last, with a 3×3 kernel: conv2d
    (fwd), conv2d_input (dx) or conv2d_weight (dtaps)."""
    import torch.nn.functional as F

    def nhwc(*shape):
        return _rnd(gen, *shape, dtype=dt).contiguous(memory_format=torch.channels_last)

    x, wt = nhwc(n, cin, hp, wp), nhwc(cout, cin, 3, 3)
    y = F.conv2d(x, wt, stride=stride)
    gy = nhwc(*y.shape)
    if kind == "fwd":
        return lambda: F.conv2d(x, wt, stride=stride)
    if kind == "dx":
        return lambda: torch.nn.grad.conv2d_input(x.shape, wt, gy, stride=stride)
    return lambda: torch.nn.grad.conv2d_weight(x, wt.shape, gy, stride=stride)


def serving_cases():
    """(kernel, label, make(dtype, gen) -> Case, group) at the serving shapes."""
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    B, (w0, w1, w2) = BATCH, WIDTHS

    def phase(h, w, cin, cout, n_sets, out_phases, with_act):
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            stride = 2 if out_phases == (2,) else 1
            return Case(lambda: pk.phase_conv_fwd(ph, sets, "average", out_phases, a),
                        lambda: pk.phase_conv_fwd_plain(ph, sets, "average", out_phases, a),
                        conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout),
                        [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                              2 * w + 2, stride))
        return make

    def up(h, w, cin, cout):
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            return Case(lambda: pk.up_dual_conv_fwd(x, sets),
                        lambda: pk.up_dual_conv_fwd_plain(x, sets),
                        conv_flops(B, 4 * 5 * h * w, cin, 2 * cout), [x, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2))
        return make

    def std(h, w, c):
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, c, dtype=dt)
            t, b = _taps(gen, c, c, dt)
            a = _act(gen, c)
            return Case(lambda: ck.ico_conv_s2s_fwd(x, t, b, "average", a),
                        lambda: ck.ico_conv_s2s_fwd_plain(x, t, b, "average", a),
                        conv_flops(B, 5 * h * w, c, c), [x, t, b, a],
                        cudnn("fwd", gen, dt, B * 5, c, c, h + 2, w + 2))
        return make

    def head(h, w, c):
        def make(dt, gen):
            b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            aff = [*_act(gen, c), *_act(gen, c)]
            W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt)
            return Case(lambda: pk.pair_head_fwd(b0, y10, aff, W, bias),
                        lambda: pk.pair_head_fwd_plain(b0, y10, aff, W, bias),
                        head_flops(B, h, w, c, 3), [b0, y10, aff, W, bias])
        return make

    cases = [
        ("phase_conv_fwd", "conv_in (16,32) 3->64", phase(16, 32, 3, w0, 1, (0, 1, 2, 3), False)),
        ("phase_conv_fwd", "down0 s2 (16,32) 64->2x128", phase(16, 32, w0, w1, 2, (2,), True)),
        ("phase_conv_fwd", "down1 s2 (8,16) 128->2x256", phase(8, 16, w1, w2, 2, (2,), True)),
        ("phase_conv_fwd", "down2 s2 (4,8) 256->2x256", phase(4, 8, w2, w2, 2, (2,), True)),
        ("phase_conv_fwd", "up0 conv01 (4,8) 256->256", phase(4, 8, w2, w2, 1, (0, 1, 2, 3), True)),
        ("phase_conv_fwd", "up1 conv01 (8,16) 128->128", phase(8, 16, w1, w1, 1, (0, 1, 2, 3), True)),
        ("phase_conv_fwd", "up2 conv01 (16,32) 64->64", phase(16, 32, w0, w0, 1, (0, 1, 2, 3), True)),
        ("up_dual_conv_fwd", "up0 (4,8) 256->2x256", up(4, 8, w2, w2)),
        ("up_dual_conv_fwd", "up1 (8,16) 256->2x128", up(8, 16, w2, w1)),
        ("up_dual_conv_fwd", "up2 (16,32) 128->2x64", up(16, 32, w1, w0)),
        ("ico_conv_s2s_fwd", "down0 conv01 (16,32) 128", std(16, 32, w1)),
        ("ico_conv_s2s_fwd", "down1 conv01 (8,16) 256", std(8, 16, w2)),
        ("ico_conv_s2s_fwd", "down2 conv01 (4,8) 256", std(4, 8, w2)),
        ("pair_head_fwd", "head (16,32) 64->3", head(16, 32, w0)),
    ]
    # the VAE's own shapes: its heads (no act) and up0 from the 512-channel latent
    vae = [
        ("phase_conv_fwd", "VAE heads s2 (4,8) 256->2x512", phase(4, 8, w2, LATENT, 2, (2,), False)),
        ("up_dual_conv_fwd", "VAE up0 (4,8) 512->2x256", up(4, 8, LATENT, w2)),
    ]

    def split(h, w, cin, cout, with_act):
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            a = _act(gen, cin) if with_act else None
            return Case(lambda: pk.ds2s_fwd(ph, sets, "average", a),
                        lambda: pk.ds2s_fwd_plain(ph, sets, "average", a),
                        conv_flops(B, 5 * h * w, cin, 2 * cout), [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 1, 2 * w + 2, 2))
        return make

    def pair(h, w, cin, cout):
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            return Case(lambda: pk.up_pair_fwd(b0, y10, aff, sets),
                        lambda: pk.up_pair_fwd_plain(b0, y10, aff, sets),
                        conv_flops(B, 4 * 5 * h * w, cin, 2 * cout), [b0, y10, aff, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2))
        return make

    # the phase chains (the AE's, and the VAE trunk's down0-1): m at the
    # DownBlocks (an act prologue at down0 only), conv01 as the phase conv;
    # n at up1 and up2 (the AE's and the VAE's decoders share these shapes)
    chain = [
        ("ds2s_fwd", "down0 s2 split (16,32) 64->2x128", split(16, 32, w0, w1, True)),
        ("ds2s_fwd", "down1 s2 split (8,16) 128->2x256 (no act)", split(8, 16, w1, w2, False)),
        ("ds2s_fwd", "down2 s2 split (4,8) 256->2x256 (no act)", split(4, 8, w2, w2, False)),
        ("phase_conv_fwd", "down0 conv01 (8,16) 128->128", phase(8, 16, w1, w1, 1, _ALL, True)),
        ("phase_conv_fwd", "down1 conv01 (4,8) 256->256", phase(4, 8, w2, w2, 1, _ALL, True)),
        ("phase_conv_fwd", "down2 conv01 (2,4) 256->256", phase(2, 4, w2, w2, 1, _ALL, True)),
        ("up_pair_fwd", "up1 pair (8,16) 256->2x128", pair(8, 16, w2, w1)),
        ("up_pair_fwd", "up2 pair (16,32) 128->2x64", pair(16, 32, w1, w0)),
    ]
    return ([(*c, "AE") for c in cases] + [(*c, "VAE") for c in vae]
            + [(*c, "chain") for c in chain])


def head_flops(B, h, w, c, F, backward=False):
    """The join (5 FLOPs a channel) and the 1×1 head (2·C·F) of every cell of
    the four phases; the backward recomputes both and adds dW and dt."""
    per_cell = 5 * c + 2 * c * F
    return 4 * B * 5 * h * w * (per_cell + (2 * 2 * c * F + 6 * c if backward else 0))


def training_cases():
    """(kernel, label, make, group) at the shapes of AE and VAE training
    (s=5, B=36): the forward kernels with BatchNorm stats, the six conv
    backward kernels with the stats fold, the head's backward, and the
    head+MSE forward and backward."""
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    B, (w0, w1, w2) = TRAIN_BATCH, WIDTHS

    def cotangents(gen, dt, h, w, cout, n_sets, n_out):
        """g and forward outputs y per set, and small stats cotangents gs."""
        def group():
            return [[_rnd(gen, B, 5, h, w, cout, dtype=dt) for _ in range(n_out)]
                    for _ in range(n_sets)]
        return group(), group(), [_rnd(gen, 2, cout, scale=1e-3) for _ in range(n_sets)]

    def phase_fwd(h, w, cin, cout, n_sets=1, out_phases=(0, 1, 2, 3), with_act=True):
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            stride = 2 if out_phases == (2,) else 1
            return Case(lambda: pk.phase_conv_fwd(ph, sets, "average", out_phases, a, True),
                        lambda: pk.phase_conv_fwd_plain(ph, sets, "average", out_phases, a,
                                                        True),
                        conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout),
                        [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                              2 * w + 2, stride))
        return make

    def up_fwd(h, w, cin, cout):
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            return Case(lambda: pk.up_dual_conv_fwd(x, sets, "average", True),
                        lambda: pk.up_dual_conv_fwd_plain(x, sets, "average", True),
                        conv_flops(B, 4 * 5 * h * w, cin, 2 * cout), [x, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2))
        return make

    def std_fwd(h, w, c):
        def make(dt, gen):
            x, (t, b), a = _rnd(gen, B, 5, h, w, c, dtype=dt), _taps(gen, c, c, dt), _act(gen, c)
            return Case(lambda: ck.ico_conv_s2s_fwd(x, t, b, "average", a, True),
                        lambda: ck.ico_conv_s2s_fwd_plain(x, t, b, "average", a, True),
                        conv_flops(B, 5 * h * w, c, c), [x, t, b, a],
                        cudnn("fwd", gen, dt, B * 5, c, c, h + 2, w + 2))
        return make

    def phase_bwd(which, h, w, cin, cout, n_sets, out_phases, with_act=True, emit_gsum=False,
                  fold=True):
        """A phase-conv dx or dtaps call; without the fold (the fold outside
        the kernels) it gets neither y nor gs, and dtaps emits Σg."""
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            g, y, gs = cotangents(gen, dt, h, w, cout, n_sets, len(out_phases))
            y, gs = (y, gs) if fold else (None, None)
            stride = 2 if out_phases == (2,) else 1
            flops = conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                        2 * w + 2, stride)
            if which == "dx":
                args = (g, sets, "average", out_phases, cin, dt, a, ph, y, gs)
                return Case(lambda: pk.phase_conv_dx(*args),
                            lambda: pk.phase_conv_dx_plain(*args), flops,
                            [g, [t for t, _ in sets], a, ph, y, gs], lib)
            args = (ph, g, [(7, cin, cout)] * n_sets, "average", out_phases, a, y, gs,
                    emit_gsum or not fold)
            return Case(lambda: pk.phase_conv_dtaps(*args),
                        lambda: pk.phase_conv_dtaps_plain(*args), flops, [ph, g, a, y, gs], lib)
        return make

    def split_fwd(h, w, cin, cout, with_act):
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            a = _act(gen, cin) if with_act else None
            return Case(lambda: pk.ds2s_fwd(ph, sets, "average", a, True),
                        lambda: pk.ds2s_fwd_plain(ph, sets, "average", a, True),
                        conv_flops(B, 5 * h * w, cin, 2 * cout), [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 1, 2 * w + 2, 2))
        return make

    def split_bwd(which, h, w, cin, cout, with_act, fold):
        """m's dx or dtaps on the level-s input phases (h, w): the 2 x 4
        phase cotangents (h/2, w/2) with the fold in the kernel, or none
        (the fold outside: dtaps then emits Σg)."""
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            a = _act(gen, cin) if with_act else None
            g, y, gs = cotangents(gen, dt, h // 2, w // 2, cout, 2, 4)
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            flops = conv_flops(B, 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 1, 2 * w + 2, 2)
            if which == "dx":
                args = (g, sets, "average", cin, dt, a, ph if a else None)
                return Case(lambda: pk.ds2s_dx(*args, **fk), lambda: pk.ds2s_dx_plain(*args, **fk),
                            flops, [g, [t for t, _ in sets], a, ph if a else None,
                                    list(fk.values())], lib)
            args = (ph, g, [(7, cin, cout)] * 2, "average", a)
            return Case(lambda: pk.ds2s_dtaps(*args, **fk, emit_gsum=not fold),
                        lambda: pk.ds2s_dtaps_plain(*args, **fk, emit_gsum=not fold), flops,
                        [ph, g, a, list(fk.values())], lib)
        return make

    def geff(h, w, c, fold_cost=None):
        """l over a group of 4 phases (B, 5, h, w, c); with ``fold_cost`` =
        (h, w, cin) of m's input, also m's dx + dtaps with the fold in the
        kernels and without it, whose difference is what l replaces."""
        def make(dt, gen):
            g = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            gs = _rnd(gen, 2, c, scale=1e-3)
            compare = {}
            if fold_cost:
                hi, wi, cin = fold_cost
                ph = [_rnd(gen, B, 5, hi, wi, cin, dtype=dt) for _ in range(4)]
                sets = [_taps(gen, cin, c, dt) for _ in range(2)]
                a = _act(gen, cin)
                gg = [g, [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]]
                yy = [y, [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]]

                def m_pair(fold):
                    fk = dict(y_groups=yy, gs_list=[gs, gs]) if fold else {}
                    pk.ds2s_dx(gg, sets, "average", cin, dt, a, ph, **fk)
                    pk.ds2s_dtaps(ph, gg, [(7, cin, c)] * 2, "average", a, **fk,
                                  emit_gsum=not fold)
                compare = {"m dx + dtaps with the fold in-kernel": lambda: m_pair(True),
                           "without it": lambda: m_pair(False)}
            return Case(lambda: pk.stats_geff(g, y, gs), lambda: pk.geff_plain(g, y, gs),
                        4 * 4 * B * 5 * h * w * c, [g, y, gs], compare=compare, short=True)
        return make

    def pair_fwd(h, w, cin, cout):
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            return Case(lambda: pk.up_pair_fwd(b0, y10, aff, sets, "average", True),
                        lambda: pk.up_pair_fwd_plain(b0, y10, aff, sets, "average", True),
                        conv_flops(B, 4 * 5 * h * w, cin, 2 * cout), [b0, y10, aff, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2))
        return make

    def pair_bwd(which, h, w, cin, cout, fold):
        """n's dx (with Σg) or dtaps on the level-s (h, w) pair, with the fold
        in the kernel or none (the fold outside)."""
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2)
            reads = [g, b0, y10, aff, list(fk.values())]
            if which == "dx":
                args = (g, b0, y10, aff, sets, "average")
                return Case(lambda: pk.up_pair_dx(*args, emit_gsum=True, **fk),
                            lambda: pk.up_pair_dx_plain(*args, emit_gsum=True, **fk), flops,
                            [*reads, [t for t, _ in sets]], lib)
            args = (b0, y10, aff, g, "average")
            return Case(lambda: pk.up_pair_dtaps(*args, **fk),
                        lambda: pk.up_pair_dtaps_plain(*args, **fk), flops, reads, lib)
        return make

    def up_bwd(which, h, w, cin, cout):
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2)
            if which == "dx":
                args = (g, sets, "average", dt, y, gs, True)
                return Case(lambda: pk.up_dual_conv_dx(*args),
                            lambda: pk.up_dual_conv_dx_plain(*args), flops,
                            [g, [t for t, _ in sets], y, gs], lib)
            args = (x, g, "average", y, gs)
            return Case(lambda: pk.up_dual_conv_dtaps(*args),
                        lambda: pk.up_dual_conv_dtaps_plain(*args), flops, [x, g, y, gs], lib)
        return make

    def std_bwd(which, h, w, c):
        def make(dt, gen):
            x, (t, _), a = _rnd(gen, B, 5, h, w, c, dtype=dt), _taps(gen, c, c, dt), _act(gen, c)
            gg, yy, gss = cotangents(gen, dt, h, w, c, 1, 1)
            g, y, gs = gg[0][0], yy[0][0], gss[0]
            flops = conv_flops(B, 5 * h * w, c, c)
            lib = cudnn(which, gen, dt, B * 5, c, c, h + 2, w + 2)
            if which == "dx":
                args = (g, t, "average", dt, a, x, y, gs, True)
                return Case(lambda: ck.ico_conv_s2s_dx(*args),
                            lambda: ck.ico_conv_s2s_dx_plain(*args), flops, [g, t, a, x, y, gs],
                            lib)
            args = (x, g, "average", a, y, gs)
            return Case(lambda: ck.ico_conv_s2s_dtaps(*args),
                        lambda: ck.ico_conv_s2s_dtaps_plain(*args), flops, [x, g, a, y, gs], lib)
        return make

    def head_mse(which, h, w, c):
        def make(dt, gen):
            b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            aff = [*_act(gen, c), *_act(gen, c)]
            W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt, scale=0.1)
            tpack = torch.rand(B, 5, h, w, 12, generator=gen, device="cuda") * 2 - 1
            tpoles = torch.rand(B, 6, generator=gen, device="cuda") * 2 - 1
            args = (b0, y10, aff, W, bias, tpack, tpoles)
            if which == "fwd":
                return Case(lambda: pk.pair_head_mse_fwd(*args),
                            lambda: pk.pair_head_mse_fwd_plain(*args),
                            head_flops(B, h, w, c, 3), args)
            g = torch.rand(B, generator=gen, device="cuda")
            return Case(lambda: pk.pair_head_mse_bwd(g, *args),
                        lambda: pk.pair_head_mse_bwd_plain(g, *args),
                        head_flops(B, h, w, c, 3, backward=True), [g, *args])
        return make

    def head_bwd(h, w, c):
        def make(dt, gen):
            b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            aff = [*_act(gen, c), *_act(gen, c)]
            W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt, scale=0.1)
            g = tuple(_rnd(gen, B, 5, h, w, 3) for _ in range(4))
            args = (g, b0, y10, aff, W, bias)
            return Case(lambda: pk.pair_head_bwd(*args), lambda: pk.pair_head_bwd_plain(*args),
                        head_flops(B, h, w, c, 3, backward=True), args)
        return make

    def merged_bwd(kind, h, w, cin, cout, n_sets=1, out_phases=(0, 1, 2, 3), with_act=True):
        """Kernel i ("phase"), j ("up") or k ("std") with the stats fold, the
        split pair it replaces (dx with its Σg pass, then dtaps) and cuDNN's
        dx + dweight on the haloed input. FLOPs: dx + dtaps."""
        def make(dt, gen):
            a = _act(gen, cin) if with_act else None
            if kind == "up":
                x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
                sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
                g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
                args = (x, g, sets, "average", y, gs)
                fn, plain = pk.up_dual_conv_bwd, pk.up_dual_conv_bwd_plain
                split = (lambda: pk.up_dual_conv_dx(g, sets, "average", dt, y, gs, True),
                         lambda: pk.up_dual_conv_dtaps(x, g, "average", y, gs))
                reads = [x, g, y, gs, [t for t, _ in sets]]
                rows, ntot, stride, halo = 4 * 5 * h * w, 2 * cout, 1, (2 * h + 2, 2 * w + 2)
            elif kind == "std":
                x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
                t, _ = _taps(gen, cin, cout, dt)
                gg, yy, gss = cotangents(gen, dt, h, w, cout, 1, 1)
                g, y, gs = gg[0][0], yy[0][0], gss[0]
                args = (x, g, t, y, gs, "average", a, True, dt)
                fn, plain = ck.ico_conv_s2s_bwd, ck.ico_conv_s2s_bwd_plain
                split = (lambda: ck.ico_conv_s2s_dx(g, t, "average", dt, a, x, y, gs, True),
                         lambda: ck.ico_conv_s2s_dtaps(x, g, "average", a, y, gs))
                reads = [x, g, y, gs, t, a]
                rows, ntot, stride, halo = 5 * h * w, cout, 1, (h + 2, w + 2)
            else:
                x = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
                sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
                g, y, gs = cotangents(gen, dt, h, w, cout, n_sets, len(out_phases))
                args = (x, g, y, gs, sets, "average", out_phases, a, True, dt)
                fn, plain = pk.phase_conv_bwd, pk.phase_conv_bwd_plain
                shapes = [(7, cin, cout)] * n_sets
                split = (lambda: pk.phase_conv_dx(g, sets, "average", out_phases, cin, dt, a, x,
                                                  y, gs),
                         lambda: pk.phase_conv_dtaps(x, g, shapes, "average", out_phases, a, y,
                                                     gs))
                reads = [x, g, y, gs, [t for t, _ in sets], a]
                stride = 2 if out_phases == (2,) else 1
                rows, ntot = len(out_phases) * 5 * h * w, n_sets * cout
                halo = (2 * h + 3 - stride, 2 * w + 2)
            lib_dx = cudnn("dx", gen, dt, B * 5, cin, ntot, *halo, stride)
            lib_dw = cudnn("dtaps", gen, dt, B * 5, cin, ntot, *halo, stride)
            return Case(lambda: fn(*args), lambda: plain(*args),
                        2 * conv_flops(B, rows, cin, ntot), reads,
                        lambda: (lib_dx(), lib_dw()), split)
        return make

    conv01 = [("up0 conv01 (4,8) 256->256", (4, 8, w2, w2)),
              ("up1 conv01 (8,16) 128->128", (8, 16, w1, w1)),
              ("up2 conv01 (16,32) 64->64", (16, 32, w0, w0))]
    down = [("down0 s2 (16,32) 64->2x128", (16, 32, w0, w1)),
            ("down1 s2 (8,16) 128->2x256", (8, 16, w1, w2)),
            ("down2 s2 (4,8) 256->2x256", (4, 8, w2, w2))]
    ups = [("up0 (4,8) 256->2x256", (4, 8, w2, w2)), ("up1 (8,16) 256->2x128", (8, 16, w2, w1)),
           ("up2 (16,32) 128->2x64", (16, 32, w1, w0))]
    std = [("down0 conv01 (16,32) 128", (16, 32, w1)), ("down1 conv01 (8,16) 256", (8, 16, w2)),
           ("down2 conv01 (4,8) 256", (4, 8, w2))]
    cases = [("phase_conv_fwd", "conv_in (16,32) 3->64 +stats",
              phase_fwd(16, 32, 3, w0, with_act=False))]
    cases += [("phase_conv_fwd", f"{label} act+stats", phase_fwd(*shape, 2, (2,)))
              for label, shape in down]
    cases += [("phase_conv_fwd", f"{label} +stats", phase_fwd(*shape)) for label, shape in conv01]
    cases += [("up_dual_conv_fwd", f"{label} +stats", up_fwd(*shape)) for label, shape in ups]
    cases += [("ico_conv_s2s_fwd", f"{label} act+stats", std_fwd(*shape)) for label, shape in std]
    for which in ("dx", "dtaps"):
        name = f"phase_conv_{which}"
        cases += [(name, f"{label} act+fold", phase_bwd(which, *shape, 1, (0, 1, 2, 3)))
                  for label, shape in conv01]
        cases += [(name, f"{label} act+fold", phase_bwd(which, *shape, 2, (2,)))
                  for label, shape in down]
        cases += [(f"up_dual_conv_{which}", f"{label} fold", up_bwd(which, *shape))
                  for label, shape in ups]
        cases += [(f"ico_conv_s2s_{which}", f"{label} act+fold+bias", std_bwd(which, *shape))
                  for label, shape in std]
    # conv_in trains without dx, so its dtaps call emits the bias gradient
    cases += [("phase_conv_dtaps", "conv_in (16,32) 3->64 fold+bias",
               phase_bwd("dtaps", 16, 32, 3, w0, 1, (0, 1, 2, 3), with_act=False,
                         emit_gsum=True))]
    cases += [(f"pair_head_mse_{which}", "head (16,32) 64->3", head_mse(which, 16, 32, w0))
              for which in ("fwd", "bwd")]
    # the AE's DownBlocks after down0 run their stride-2 convs without an act
    # prologue (the pending BN-apply is down0's alone)
    no_act = [(f"phase_conv_{which}", f"{label} fold (no act)",
               phase_bwd(which, *shape, 2, (2,), with_act=False))
              for which in ("dx", "dtaps") for label, shape in down[1:]]
    no_act = [("phase_conv_fwd", f"{label} +stats (no act)", phase_fwd(*shape, 2, (2,), False))
              for label, shape in down[1:]] + no_act
    heads = ("VAE heads s2 (4,8) 256->2x512", (4, 8, w2, LATENT))
    up0 = ("VAE up0 (4,8) 512->2x256", (4, 8, LATENT, w2))
    vae = [("phase_conv_fwd", f"{heads[0]} +stats", phase_fwd(*heads[1], 2, (2,), False)),
           ("up_dual_conv_fwd", f"{up0[0]} +stats", up_fwd(*up0[1]))]
    vae += [(f"phase_conv_{which}", f"{heads[0]} fold",
             phase_bwd(which, *heads[1], 2, (2,), with_act=False)) for which in ("dx", "dtaps")]
    vae += [(f"up_dual_conv_{which}", f"{up0[0]} fold", up_bwd(which, *up0[1]))
            for which in ("dx", "dtaps")]
    vae += [("pair_head_bwd", "head (16,32) 64->3", head_bwd(16, 32, w0))]
    # the merged route's kernels i, j, k at every site they run at, with the
    # fold (every site has stats); the DownBlocks after down0 and the VAE's
    # heads have no act prologue
    merged = [("phase_conv_bwd", f"{label} act+fold", merged_bwd("phase", *shape, 1))
              for label, shape in conv01]
    merged += [("phase_conv_bwd", f"{label} {'act+fold' if k == 0 else 'fold (no act)'}",
                merged_bwd("phase", *shape, 2, (2,), with_act=k == 0))
               for k, (label, shape) in enumerate(down)]
    merged += [("up_dual_conv_bwd", f"{label} fold", merged_bwd("up", *shape))
               for label, shape in ups]
    merged += [("ico_conv_s2s_bwd", f"{label} act+fold", merged_bwd("std", shape[0], shape[1],
                                                                    shape[2], shape[2]))
               for label, shape in std]
    vae += [("phase_conv_bwd", f"{heads[0]} fold",
             merged_bwd("phase", *heads[1], 2, (2,), with_act=False)),
            ("up_dual_conv_bwd", f"{up0[0]} fold", merged_bwd("up", *up0[1]))]
    # the phase chain (the AE's, and the VAE trunk's down0-1): m at the
    # DownBlocks with the fold in-kernel and (kernel_geff="") without; conv01
    # as the phase conv at the level-(s-1) phases, also merged (i); l at
    # each group it folds there (conv01 and m's outputs, per set; the
    # decoder's conv01 at (16,32) 64)
    chain = []
    for k, (label, (h, w, cin, cout)) in enumerate(down):
        label = label.replace("s2", "s2 split")
        tail = "" if k == 0 else " (no act)"
        chain.append(("ds2s_fwd", f"{label} {'act+' if k == 0 else ''}stats{tail}",
                      split_fwd(h, w, cin, cout, k == 0)))
        for which in ("dx", "dtaps"):
            chain += [(f"ds2s_{which}", f"{label} {'act+' if k == 0 else ''}{f}{tail}",
                       split_bwd(which, h, w, cin, cout, k == 0, f == "fold"))
                      for f in ("fold", "no fold")]
    conv01_chain = [("down0 conv01 (8,16) 128->128", (8, 16, w1, w1)),
                    ("down1 conv01 (4,8) 256->256", (4, 8, w2, w2)),
                    ("down2 conv01 (2,4) 256->256", (2, 4, w2, w2))]
    for label, shape in conv01_chain:
        chain.append(("phase_conv_fwd", f"{label} act+stats", phase_fwd(*shape)))
        for which in ("dx", "dtaps"):
            chain += [(f"phase_conv_{which}", f"{label} act+{f}",
                       phase_bwd(which, *shape, 1, _ALL, fold=f == "fold"))
                      for f in ("fold", "no fold")]
        chain.append(("phase_conv_bwd", f"{label} act+fold", merged_bwd("phase", *shape, 1)))
    chain += [("stats_geff", "down0 (8,16) 4x128", geff(8, 16, w1, fold_cost=(16, 32, w0))),
              ("stats_geff", "down1 (4,8) 4x256", geff(4, 8, w2)),
              ("stats_geff", "down2 (2,4) 4x256", geff(2, 4, w2)),
              ("stats_geff", "up2 conv01 (16,32) 4x64", geff(16, 32, w0))]
    # the decoder's chain: n at up1 and up2, the fold in the kernels and not
    for label, (h, w, cin, cout) in ups[1:]:
        label = label.replace(" (", " pair (")
        chain.append(("up_pair_fwd", f"{label} +stats", pair_fwd(h, w, cin, cout)))
        for which in ("dx", "dtaps"):
            chain += [(f"up_pair_{which}", f"{label} {f}",
                       pair_bwd(which, h, w, cin, cout, f == "fold"))
                      for f in ("fold", "no fold")]
    return ([(*c, "AE") for c in cases + merged] + [(*c, "AE no act") for c in no_act]
            + [(*c, "VAE") for c in vae] + [(*c, "chain") for c in chain])


def flat(out):
    """Nested tuples/lists of tensors (None allowed) -> list of tensors."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def bound(case: Case, outputs, dt):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move (each input read once, each output written once) over the
    memory rate, and its FLOPs over the peak for its dtype."""
    nbytes = sum(t.numel() * t.element_size() for t in case.inputs + outputs)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, case.flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(card: str, cases, phase: str, reps: int = 20) -> dict:
    """Phases 3 and 4. Returns per kernel its largest max_abs_err over its
    cases and, summed over its shapes in bf16: ms and plain_ms (median
    times), bound_ms (with what bounds the largest share of it),
    library_ms (None where no cuDNN call does the same work) and, for a
    merged backward kernel, split_ms (the split pair: split_dx_ms +
    split_dtaps_ms); ``by_shapes`` holds the same sums per group of shapes."""
    def sums():
        return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}, "library_ms": None}

    def add(s, key, v):
        s[key] = (s.get(key) or 0.0) + v

    stats = collections.defaultdict(lambda: {"max_abs_err": 0.0, **sums(), "by_shapes": {}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, make, group in cases:
        for dt in (torch.float32, torch.bfloat16):
            case = make(dt, gen)
            got, ref = flat(case.kernel()), flat(case.plain())
            torch.cuda.synchronize()
            if len(got) != len(ref):
                raise AssertionError(f"{name} {label}: {len(got)} outputs, plain {len(ref)}")
            # each output is held against its own max|ref|
            errs = [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
                    for g, r in zip(got, ref)]
            rel, err, scale = max((e / s if s else (math.inf if e else 0.0), e, s)
                                  for e, s in errs)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ms, plain_ms = cuda_ms(case.kernel, reps), cuda_ms(case.plain, reps)
            event = ""
            if case.short:  # the events measured the wrapper: the trace gives the kernel
                event, ms = f" (CUDA events around one call: {ms:.4f} ms)", trace_ms(case.kernel)
            lib_ms = cuda_ms(case.library, reps) if case.library is not None else None
            split_ms = [cuda_ms(f, reps) for f in case.split] if case.split else None
            compare_ms = {k: cuda_ms(f, reps) for k, f in case.compare.items()}
            b_ms, b_by = bound(case, got, dt)
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            lib = ("none" if lib_ms is None else
                   f"{lib_ms:.4f} ms (cuDNN, contraction only, on a haloed input)")
            split = ("" if split_ms is None else
                     f", split pair {sum(split_ms):.4f} ms (dx + Σg {split_ms[0]:.4f}, dtaps "
                     f"{split_ms[1]:.4f})")
            split += "".join(f", {k} {v:.4f} ms" for k, v in compare_ms.items())
            print(f"[{phase}] {name} {label} {tag}: worst of {len(got)} outputs "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={rel:.3e} tol={TOL[dt]:.0e} "
                  f"({TOL_WHY[dt]}); kernel {ms:.4f} ms{event}, plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), library {lib}{split} [{card}]", flush=True)
            if not finite or not rel <= TOL[dt]:
                raise AssertionError(f"{name} {label} {tag}: error {err} over tolerance "
                                     f"{TOL[dt]} x {scale} (finite={finite})")
            stats[name]["max_abs_err"] = max([stats[name]["max_abs_err"]] + [e for e, _ in errs])
            if dt == torch.bfloat16:
                for s in (stats[name], stats[name]["by_shapes"].setdefault(group, sums())):
                    s["ms"] += ms
                    s["plain_ms"] += plain_ms
                    s["bound_ms"] += b_ms
                    s["bound_by"][b_by] = s["bound_by"].get(b_by, 0.0) + b_ms
                    if lib_ms is not None:
                        add(s, "library_ms", lib_ms)
                    if split_ms is not None:
                        add(s, "split_ms", sum(split_ms))
                        add(s, "split_dx_ms", split_ms[0])
                        add(s, "split_dtaps_ms", split_ms[1])
                    for k, v in compare_ms.items():
                        s.setdefault("compare_ms", {})[f"{label}: {k}"] = v
            del case, got, ref
    for s in stats.values():
        for t in (s, *s["by_shapes"].values()):
            t["bound_by"] = max(t["bound_by"], key=t["bound_by"].get)
    return stats


def check_mesh(vertices, n: int, what: str):
    import numpy as np

    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    if v.shape[0] != n or not np.isfinite(v).all():
        raise AssertionError(f"{what}: {v.shape[0]} vertices (want {n}), "
                             f"finite={bool(np.isfinite(v).all())}")


def model_config(model: str, dtype_name: str):
    from geniconet_tpu_torch import Config

    cfg = Config()
    cfg.model.name = model
    cfg.model.subdivisions, cfg.model.widths = SUBDIVISIONS, WIDTHS
    cfg.model.latent_features = LATENT
    cfg.model.compute_dtype = dtype_name
    return cfg


def serve(model: str, dtype_name: str, variables, card: str, phase_chain=None):
    """Phase 5 for one model and compute dtype: load + requests. Returns the state."""
    from geniconet_tpu_torch import geometry as ico
    from geniconet_tpu_torch.app.server import handle_api
    from geniconet_tpu_torch.app.state import AppState

    cfg = model_config(model, dtype_name)
    cfg.data.synthetic = N_MESHES
    V = ico.num_vertices(SUBDIVISIONS)
    tag = f"serve {model} {dtype_name}{' phase_chain=' + phase_chain if phase_chain else ''}"
    st = AppState(device="cuda")
    t0 = time.perf_counter()
    info = st.load(cfg, variables, phase_chain=phase_chain)
    torch.cuda.synchronize()
    print(f"[{tag}] load: {info['n']} meshes, latent {info['latent_shape']}, "
          f"{time.perf_counter() - t0:.2f} s (dataset build included)", flush=True)
    if handle_api(st, "/api/info", {})["n"] != N_MESHES or info["is_vae"] != cfg.model.is_vae:
        raise AssertionError("/api/info: wrong mesh count or model kind")
    requests = [
        ("/api/mesh", {"i": 0, "coloring": "patch"}),
        ("/api/interpolate", {"i": 0, "j": 1, "t": 0.5, "coloring": "patch"}),
        ("/api/explore", {"i": 0, "channel": 3, "delta": 1.5, "coloring": "patch"}),
    ]
    if cfg.model.is_vae:
        requests.append(("/api/regenerate", {"i": 1, "k": 1.0, "seed": 3, "coloring": "patch"}))
    for path, body in requests:
        check_mesh(handle_api(st, path, body)["vertices"], V, f"{tag} {path}")
    out = handle_api(st, "/api/decode", {"indices": list(range(8))})
    if len(out["vertices"]) != 8:
        raise AssertionError(f"/api/decode returned {len(out['vertices'])} meshes")
    for k, v in enumerate(out["vertices"]):
        check_mesh(v, V, f"{tag} /api/decode mesh {k}")
    print(f"[{tag}] /api/info {' '.join(p for p, _ in requests)} /api/decode(8): "
          f"every mesh {V} finite vertices [{card}]", flush=True)
    return st


def plain_route_check(st, card: str):
    """Two float32 decodes on the card against the same model on the CPU."""
    model = st.cfg.model.name
    from geniconet_tpu_torch.ops.vertices import grid_to_vertices

    z = st.latents[:2]
    got = st.decode_batch(z)
    cpu_model = copy.deepcopy(st.model).cpu()
    with torch.inference_mode():
        ref = grid_to_vertices(cpu_model.decode(torch.from_numpy(z)), SUBDIVISIONS).numpy()
    err = float(abs(got - ref).max())
    scale = float(abs(ref).max())
    print(f"[serve {model} float32] kernel route vs plain route on CPU, 2 meshes: "
          f"max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} tol=1e-4 x max|ref| [{card}]", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"kernel route differs from the plain route: {err}")


def chain_cache_check(chained, unchained, dtype_name: str, card: str):
    """The latent cache built through the phase chain against the unchained
    one (the VAE's mu and logvar), and, where the decoder is chained, 4
    decodes of the unchained latents: eval BatchNorm uses the running
    statistics, so the chained and unchained models compute one function
    with other sums; within TOL of max|ref|."""
    import numpy as np

    dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
    pairs = [(f"latent cache of {N_MESHES} meshes", chained.latents, unchained.latents)]
    if unchained.logvars is not None:
        pairs.append((f"logvar cache of {N_MESHES} meshes", chained.logvars, unchained.logvars))
    chain = chained.model.phase_chain
    if chain in ("1", "dec"):
        z = unchained.latents[:4]
        pairs.append(("decode of 4 latents", chained.decode_batch(z), unchained.decode_batch(z)))
    for what, got, ref in pairs:
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        print(f"[serve {chained.cfg.model.name} {dtype_name} phase_chain={chain!r}] {what} "
              f"vs the unchained model's: max_abs_err={err:.3e} "
              f"max|ref|={scale:.3e} tol={TOL[dt]:.0e} x max|ref| ({TOL_WHY[dt]}) [{card}]",
              flush=True)
        if not err <= TOL[dt] * scale:
            raise AssertionError(f"the chained {what} differs from the unchained one: {err}")


def encode_decode(st, x):
    """The model's encode then decode of x (the VAE decodes its mu)."""
    z = st.model.encode(x)
    return st.model.decode(z[0] if isinstance(z, tuple) else z)


def timings(st, dtype_name: str, card: str):
    """Phase 6: p50 single-mesh decode latency, encode+decode meshes/s at B=16."""
    lat = []
    for i in range(40):
        t0 = time.perf_counter()
        st.decode_latent(st.latents[i % N_MESHES])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat[5:]) * 1e3
    x = torch.as_tensor(st.dataset.inputs[:BATCH], device="cuda")
    with torch.inference_mode():
        ms = cuda_ms(lambda: encode_decode(st, x), reps=10)
    chain = f" phase_chain={st.model.phase_chain!r}" if st.model.phase_chain else ""
    print(f"[timing {st.cfg.model.name} {dtype_name}{chain}] p50 single-mesh decode latency {p50:.3f} ms (host clock, "
          f"latent in -> vertices out); encode+decode B={BATCH}: {ms:.3f} ms = "
          f"{BATCH / ms * 1e3:.1f} meshes/s [{card}]", flush=True)


def kernel_group(event: dict) -> str:
    """The profile's row for one device event of a Chrome trace."""
    name = event["name"]
    if event.get("cat") != "kernel":
        return event.get("cat", "other")  # gpu_memcpy, gpu_memset
    dtype = "bf16" if "bfloat16" in name else "fp32"
    loader = "UpLoad" if "UpLoad" in name else "GridLoad"
    # kernel m: the phase conv's GEMMs with the split store / split loader;
    # kernel n: the up conv's with the pair loader / the pair's dx epilogue
    split = ", split> (m)" if "true>" in name else ">"
    if "PairCells" in name or "DxPairOut" in name:
        split = ", pair> (n)"
    if "conv_gemm" in name:
        # phase_conv_fwd and ico_conv_s2s_fwd share the GridLoad instantiation
        return f"conv_gemm<{dtype}, {loader}{split}"
    if "dx_gemm" in name:
        return f"dx_gemm<{dtype}{split}"
    if "dtaps_gemm" in name:
        return f"dtaps_gemm<{dtype}, {loader}{split}"
    if "stats_geff" in name:
        return "stats_geff (l)"
    if "merged_bwd" in name:  # kernels i and k share the GridLoad instantiation
        return f"merged_bwd<{dtype}, {loader}>"
    if "sum_rows" in name or "colsum" in name:
        return "sum_rows + colsum (cross-block sums)"
    if "pair_head_kernel" in name:
        return "pair_head_kernel"
    if "phead_bwd" in name:
        return "phead_bwd (head bwd, kernel e)"
    if "phmse" in name:
        return "phmse (head+MSE fwd/bwd)"
    if any(k in name.lower() for k in ("cudnn", "xmma", "cutlass", "gemm", "conv")):
        return "cuDNN / cuBLAS (plain route)"
    return "PyTorch ops"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in the trace's µs, as ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_profile(workloads, card: str):
    """Phase 8: device time per kernel group and the idle share, for each
    (tag, fn, iterations) workload.

    Idle share = 1 - (device busy time per iteration, from the union of the
    trace's device events) / (host wall time per iteration, measured without
    the profiler, synchronised at both ends)."""
    from torch.profiler import ProfilerActivity, profile

    from geniconet_tpu_torch.ops.kernels import build

    out_dir = Path(__file__).resolve().parent / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, fn, iters in workloads:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launches = {k: v / iters for k, v in sorted(build.LAUNCHES.items())}
        trace = out_dir / f"{tag}.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not events:
            raise AssertionError(f"profile {tag}: the trace holds no device events")
        busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / iters
        span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3 / iters
        groups = collections.defaultdict(lambda: [0, 0.0])
        for e in events:
            g = groups[kernel_group(e)]
            g[0] += 1
            g[1] += e["dur"] / 1e3
        summed = sum(ms for _, ms in groups.values()) / iters
        print(f"[profile bfloat16 {tag}] {iters} iterations: host wall {wall:.4f} ms/iter "
              f"(profiler off); device busy {busy:.4f} ms/iter (union of {len(events) / iters:.1f} "
              f"device events/iter, summed {summed:.4f} ms); device idle share "
              f"{1 - busy / wall:.4f}; first-to-last device event {span:.4f} ms/iter "
              f"(profiler on); wrapper launches/iter {launches} [{card}]", flush=True)
        for name, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"[profile bfloat16 {tag}]   {name}: {n / iters:.1f} calls/iter, "
                  f"{ms / iters:.4f} ms/iter, {ms / iters / busy:.4f} of busy", flush=True)
        glue = collections.Counter()
        for e in events:
            if kernel_group(e) in ("PyTorch ops", "cuDNN / cuBLAS (plain route)"):
                glue[e["name"][:80]] += e["dur"] / 1e3 / iters
        for name, ms in glue.most_common(5):
            print(f"[profile bfloat16 {tag}]     top {name}: {ms:.4f} ms/iter", flush=True)


def serving_workloads(st, tag="", b1=True):
    """encode+decode at B=16 and, with ``b1``, decode_latent at B=1 (the
    encoder's chain leaves the decoder as it is: its B=1 decode is the
    default's)."""
    x = torch.as_tensor(st.dataset.inputs[:BATCH], device="cuda")
    z = st.latents[0]

    def run():
        with torch.inference_mode():
            encode_decode(st, x)

    return [(f"encode_decode_B{BATCH}{tag}", run, 20),
            *([(f"decode_latent_B1{tag}", lambda: st.decode_latent(z), 20)] if b1 else [])]


def train_config(dtype_name: str, batch: int, model: str = "ico2ico"):
    cfg = model_config(model, dtype_name)
    cfg.train.batch_size = batch
    return cfg


def routing(route: str) -> dict:
    """The Trainer's routing options of a path suffix of ``ROUTES``."""
    return dict(zip(("merged_bwd", "phase_chain", "kernel_geff"), ROUTES[route]))


def train(model: str, dtype_name: str, variables, dataset, card: str, route: str = ""):
    """Phase 7 for one model, compute dtype and routing (a ``ROUTES`` key):
    TRAIN_STEPS Adam steps at B=36. Returns the trainer, its state, a fixed
    batch for the profile and the kernel launches."""
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train.trainer import Trainer

    opts = routing(route)
    tr = Trainer(train_config(dtype_name, TRAIN_BATCH, model), device="cuda", **opts)
    st = tr.init_state(variables)
    batches = Batches(dataset, TRAIN_BATCH, drop_remainder=True, seed=0, device="cuda")

    def stream():
        while True:
            yield from batches.epoch()

    it = stream()
    losses, times = [], []
    build.reset_launches()
    for _ in range(TRAIN_STEPS):
        x, y, wt = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(st, x, y, wt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total"]))
    launches = dict(build.LAUNCHES)
    ms = statistics.median(times[TRAIN_WARMUP:]) * 1e3
    tag = f"train {model} {dtype_name}"
    print(f"[{tag}] {TRAIN_STEPS} steps at B={TRAIN_BATCH}, s={SUBDIVISIONS}, widths {WIDTHS}"
          f"{f', latent {LATENT}' if tr.is_vae else ''}, pallas_blocks="
          f"{tr.model.pallas_blocks!r}, {', '.join(f'{k}={v!r}' for k, v in opts.items())}: "
          f"losses {[round(v, 6) for v in losses]}; step {ms:.3f} ms (median of the last "
          f"{TRAIN_STEPS - TRAIN_WARMUP}, host clock, synchronised) = "
          f"{TRAIN_BATCH / ms * 1e3:.1f} training meshes/s [{card}]", flush=True)
    print(f"[{tag}] kernel launches on the training path: {launches}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    check_launches(f"{'VAE' if tr.is_vae else 'AE'} train{route}", launches, TRAIN_STEPS)
    # on the merged route conv_in (no dx) keeps its dtaps kernel, and on the
    # decoder's chain only up0 runs the merged up conv (j): once a step each
    once = ("phase_conv_dtaps", *(("up_dual_conv_bwd",) if opts["phase_chain"] in ("1", "dec")
                                  else ()))
    wrong = {k: launches.get(k, 0) for k in once if launches.get(k, 0) != TRAIN_STEPS}
    if opts["merged_bwd"] and wrong:
        raise AssertionError(f"{tag}: launched {wrong} times, want once a step (conv_in; up0)")
    return tr, st, next(it), launches


def check_launches(path: str, launches, forwards=None):
    """Fail unless every kernel of the path launched at least once, and none
    that the path must not run; on the decoder's chain, n (up1, up2) twice
    as often as the up conv (up0), and that once a forward where
    ``forwards`` is known."""
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    stray = [k for k in PATH_FORBIDDEN.get(path, ()) if launches.get(k, 0)]
    if stray:
        raise AssertionError(f"kernels the {path} path must not launch: {stray}")
    n, up = launches.get("up_pair_fwd", 0), launches.get("up_dual_conv_fwd", 0)
    if "up_pair_fwd" in PATH_KERNELS[path] and (n != 2 * up or forwards not in (None, up)):
        raise AssertionError(f"the {path} path launched n {n} and the up conv {up} times "
                             f"({forwards} forwards): want n twice a forward, the up conv once")


def routing_compare(variables, dataset, card: str, iters: int = 4):
    """Whole training steps (``Trainer.train_step``: forward, backward, Adam)
    at B=36 bf16 of each model under each of its routings, in turns: every
    routing once, then again in the reverse order. The AE's routings: the
    default (every block fused, the split backward kernels),
    ``merged_bwd="all"``, ``pallas_blocks="up0,up1,up2"`` (the encoder and
    the head on cuDNN and PyTorch ops), and every chained ``ROUTES`` entry
    (the encoder's chain "chain", the decoder's "chain dec", both "chain
    all", on the split and merged routes and with the fold outside); the
    VAE's: the default, the merged, the encoder's chain and both chains.
    Losses must be finite; prints each routing's median host-clock step
    time, synchronised."""
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.nn.models import IcoAE
    from geniconet_tpu_torch.train.trainer import Trainer

    chain = [(route.strip(" ()"), route, None) for route in ROUTES if "chain" in route]
    routings = {"ico2ico": (("default", "", None), ("merged", " (merged)", None),
                            ("decoder-only", "", "up0,up1,up2"), *chain),
                "ico2ico_vae": (("default", "", None), ("merged", " (merged)", None),
                                *(c for c in chain if c[0] in ("chain", "chain all")))}
    x, y, wt = next(iter(Batches(dataset, TRAIN_BATCH, drop_remainder=True, seed=0,
                                 device="cuda").epoch()))
    for model, routes in routings.items():
        trainers = {}
        for name, route, blocks in routes:
            tr = Trainer(train_config("bfloat16", TRAIN_BATCH, model), device="cuda",
                         **routing(route))
            if blocks:
                tr.model = IcoAE(SUBDIVISIONS, WIDTHS, dtype=torch.bfloat16, pallas_blocks=blocks,
                                 device="cuda")
            trainers[name] = (tr, tr.init_state(variables[model]))
        names = [name for name, _, _ in routes]
        times = collections.defaultdict(list)
        for name in names + names[::-1]:
            tr, st = trainers[name]
            for i in range(iters + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(tr.train_step(st, x, y, wt)["total"])
                torch.cuda.synchronize()
                if i:  # the first step of each turn warms up
                    times[name].append(time.perf_counter() - t0)
                if not math.isfinite(loss):
                    raise AssertionError(f"{model} {name} routing: loss {loss}")
        for name, ts in times.items():
            ms = statistics.median(ts) * 1e3
            print(f"[train routing] {model} {name}: training step at B={TRAIN_BATCH} bf16 "
                  f"{ms:.3f} ms (median of {len(ts)}, two turns, host clock, synchronised) = "
                  f"{TRAIN_BATCH / ms * 1e3:.1f} meshes/s [{card}]", flush=True)


def train_step_check(model: str, variables, card: str, routes):
    """One float32 step at B=4 on the card, per routing in ``routes``
    ((``ROUTES`` key, planted) pairs), against the same step on the CPU
    (plain route, with the routing's ``phase_chain``): the loss and the new BatchNorm statistics within 1e-4 of
    max|ref|, every gradient within 1e-4·max|ref| plus twice the float32
    spread on it. That spread is measured on both sides: the largest change
    of a step's gradient when the batch's samples come in five other orders
    (the VAE's eps, fixed for the check, permuted with its samples, so that
    each order computes the same function), on the CPU and on the card (on
    the route under check), and on the CPU also when no block is fused
    (``pallas_blocks="none"``: masked 3×3 convs, the same function with
    other float32 sums inside each sample, which a reorder leaves alone).
    The card's own spread counts because its kernels sum in fixed blocks of
    rows, which a reorder of the samples regroups and the CPU's sums do not
    show; the VAE's normal term amplifies such differences. The BatchNorm
    backward at B=4 loses digits to cancellation (a float32 gradient leaf
    moves by up to 1e-2·max|ref| with the summation order alone), so a fixed
    bound would measure the conditioning, not the kernels. The bound is that
    loose only on some leaves, which the check names. The CPU's plain
    versions of the backward routes and fold placements are the same
    function, so one CPU reference serves each ``phase_chain`` (the spread,
    measured on the default's, serves every routing). To show that the check still catches a kernel error, the
    card's step then runs once per entry of ``planted``, with that kernel
    output 1% off: the check must read above its bound for each."""
    from unittest import mock

    import numpy as np

    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.nn import models
    from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
    from geniconet_tpu_torch.ops.kernels import fused
    from geniconet_tpu_torch.train.trainer import Trainer

    ds = synthetic_dataset(SUBDIVISIONS, 4, seed=1)
    is_vae = model.endswith("_vae")
    eps = torch.from_numpy(np.random.RandomState(2).randn(
        4, 5 * 2 ** (SUBDIVISIONS - 3), 2 ** (SUBDIVISIONS - 2), LATENT).astype(np.float32))

    def fixed_eps(order, device):
        if not is_vae:
            return contextlib.nullcontext()
        e = eps[order].to(device)
        return mock.patch.object(models, "reparameterize",
                                 lambda mu, logvar, generator=None: e * torch.exp(0.5 * logvar) + mu)

    def step(device, order, unfused=False, route=""):
        tr = Trainer(train_config("float32", 4, model), device=device, **routing(route))
        if unfused:  # "none" names no block: no block is fused
            kw = dict(pallas_blocks="none", device=device)
            tr.model = (IcoVAE(SUBDIVISIONS, WIDTHS, LATENT, **kw) if is_vae
                        else IcoAE(SUBDIVISIONS, WIDTHS, **kw))
        st = tr.init_state(variables)
        x, y, wt = next(iter(Batches(ds, 4, shuffle=False, device=device).epoch()))
        with fixed_eps(order, device):
            loss = float(tr.train_step(st, x[order], y[order], wt)["total"])
        grads = {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        return loss, grads, stats

    def spread_of(base, runs):
        out = {k: 0.0 for k in base}
        for args in runs:
            _, other, _ = step(*args)
            for k, ref in base.items():
                out[k] = max(out[k], (other[k] - ref).abs().max().item())
        return out

    refs = {None: step("cpu", [0, 1, 2, 3])}  # phase_chain -> the CPU's step
    ref_grads = refs[None][1]
    orders = [[3, 2, 1, 0], [1, 0, 3, 2], [2, 3, 0, 1], [0, 2, 1, 3], [1, 3, 0, 2]]
    cpu_spread = spread_of(ref_grads, [("cpu", o) for o in orders]
                           + [("cpu", [0, 1, 2, 3], True)])
    for route, planted in routes:
        chain = routing(route)["phase_chain"]
        if chain not in refs:
            refs[chain] = step("cpu", [0, 1, 2, 3], route=route)
        ref_loss, ref_grads, ref_stats = refs[chain]
        base = step("cuda", [0, 1, 2, 3], route=route)[1]
        card_spread = spread_of(base, [("cuda", o, False, route) for o in orders])
        bounds = {}  # leaf -> (bound, scale)
        for k, ref in ref_grads.items():
            # a conv's bias feeds a BatchNorm: its exact gradient is 0, so it
            # is held against its taps' scale
            conv_bias = "conv" in k.rsplit(".", 2)[-2] and k.endswith(".bias")
            scale = (ref_grads[k[: -len("bias")] + "taps"] if conv_bias else ref).abs().max().item()
            bounds[k] = (1e-4 * scale + 2 * max(cpu_spread[k], card_spread[k]), scale)

        def card_step(route=route, bounds=bounds, ref_loss=ref_loss, ref_grads=ref_grads,
                      ref_stats=ref_stats):
            """The card's step read against the bounds: (loss, worst error / its bound, leaf)."""
            loss, grads, stats = step("cuda", [0, 1, 2, 3], route=route)
            ratio = {"loss": abs(loss - ref_loss) / (1e-4 * abs(ref_loss))}
            for k, ref in ref_stats.items():
                ratio[k] = (stats[k] - ref).abs().max().item() / (1e-4 * ref.abs().max().item())
            for k, ref in ref_grads.items():
                ratio[k] = (grads[k] - ref).abs().max().item() / bounds[k][0]
            name, worst = max(ratio.items(), key=lambda kv: kv[1])
            return loss, worst, name

        tag = f"train {model} float32{route}"
        loss, worst, name = card_step()
        loose = {k: b / s for k, (b, s) in bounds.items() if b > 2e-3 * s}
        print(f"[{tag}] one step at B=4 on the card vs the CPU plain route"
              f"{' (eps fixed)' if is_vae else ''}: loss {loss:.6f} vs {ref_loss:.6f}; loss, "
              f"{len(ref_stats)} BatchNorm statistics within 1e-4·max|ref|, {len(ref_grads)} "
              f"gradients within 1e-4·max|ref| + 2x the larger float32 spread, the CPU's over "
              f"{len(orders)} other sample orders and the unfused routing or the card's over "
              f"the orders; largest error {worst:.3f} of its bound ({name}) [{card}]", flush=True)
        widest = sorted(loose.items(), key=lambda kv: -kv[1])[:4]
        print(f"[{tag}] {len(loose)} gradients have a bound above 2e-3·max|ref| "
              f"(widest: {', '.join(f'{k} {v:.2e}' for k, v in widest)}): this check holds "
              f"them loosely, and the kernels that make them only the kernel-vs-plain phase "
              f"holds at 1e-4", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"{tag} step on the card differs from the CPU: {name} {worst}")
        missed = []
        for kernel, where, path, hit in planted:
            real = getattr(fused, kernel)

            def plant(*args, _real=real, _path=path, _hit=hit, **kwargs):
                r = _real(*args, **kwargs)
                return one_percent_off(r, _path) if _hit(args) else r

            with mock.patch.object(fused, kernel, plant):
                _, worst, name = card_step()
            print(f"[{tag}] planted fault, {kernel} 1% off at {where}: the check reads "
                  f"{worst:.3f} of its bound ({name}), "
                  f"{'caught' if worst > 1.0 else 'NOT caught'} [{card}]", flush=True)
            if not worst > 1.0:
                missed.append(f"{kernel} at {where}")
        if missed:
            raise AssertionError(f"the {tag} step check misses a planted 1% fault: {missed}")


# Kernel outputs the step checks' probes put 1% off, one at a time: (wrapper
# as ``fused`` calls it, where, index path of the output, which calls).
PLANTED = {
    "ico2ico": (
        ("ico_conv_s2s_dtaps", "down0-2 conv01, dtaps", (), lambda a: True),
        ("ico_conv_s2s_dx", "down0-2 conv01, dx", (0,), lambda a: True),
        ("ico_conv_s2s_dx", "down1 conv01, d_mul (to encoder.down1.bn00)", (1,),
         lambda a: a[0].shape[2] == 8),
        ("phase_conv_dtaps", "conv_in, dtaps", (0, 0), lambda a: a[0][0].shape[-1] == 3),
    ),
    "ico2ico_vae": (
        ("pair_head_bwd", "head, db0 phase 0", (0, 0), lambda a: True),
        ("pair_head_bwd", "head, dW", (2,), lambda a: True),
        ("phase_conv_dtaps", "heads (256->2x512), mu's dtaps", (0,),
         lambda a: a[2][0][-1] == LATENT),
        ("up_dual_conv_dx", "up0 (C_in 512), dx", (0,), lambda a: a[1][0][0].shape[1] == LATENT),
    ),
}
# ... and on the merged route: i's dtaps, j's dx and k's dtaps. k's Σg_eff
# is not among them: it is the gradient of a conv bias that feeds a
# BatchNorm, exactly 0, so 1% of it is 1% of float32 rounding noise, which
# no gradient check can see.
PLANTED_MERGED = {
    "ico2ico": (
        ("phase_conv_bwd", "down0-2 stride-2 and up0-2 conv01, dtaps of set a", (1, 0),
         lambda a: True),
        ("up_dual_conv_bwd", "up0-2, dx", (0,), lambda a: True),
        ("ico_conv_s2s_bwd", "down0-2 conv01, dtaps", (1,), lambda a: True),
    ),
    "ico2ico_vae": (
        ("phase_conv_bwd", "heads (256->2x512), mu's dtaps", (1, 0),
         lambda a: a[0][0].shape[-1] == WIDTHS[2] and a[4][0][0].shape[-1] == LATENT),
        ("up_dual_conv_bwd", "up0 (C_in 512), dx", (0,), lambda a: a[0].shape[-1] == LATENT),
        ("ico_conv_s2s_bwd", "down0-1 conv01, dtaps", (1,), lambda a: True),
    ),
}
# ... and on the phase chain (every routing; the VAE's trunk has down0-1):
# m's dx and dtaps, and with the fold outside the kernels l's output too
# (m's dtaps then also emits the bias gradients, so its dtaps are (0, 0)).
_M_DX = ("ds2s_dx", "down0-2 m, dphase 0", (0, 0), lambda a: True)
PLANTED_CHAIN = {
    " (chain)": (_M_DX, ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0,), lambda a: True)),
    " (chain, merged)": (_M_DX, ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0,),
                                 lambda a: True)),
    " (chain, fold outside)": (
        ("stats_geff", "every group it folds, phase 0", (0,), lambda a: True), _M_DX,
        ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0, 0), lambda a: True)),
}
# ... and on the decoder's chain (every routing; up1 and up2): n's forward
# output, a phase cotangent and an affine gradient of its dx, and its dtaps
PLANTED_N = (
    ("up_pair_fwd", "up1-2 n, output phase 0 of set a", (0, 0, 0), lambda a: True),
    ("up_pair_dx", "up1-2 n, db0 phase 0", (0, 0), lambda a: True),
    ("up_pair_dx", "up1-2 n, d_mul1 (to up0-1's bn01)", (2,), lambda a: True),
    ("up_pair_dtaps", "up1-2 n, dtaps of set a", (0,), lambda a: True),
)
# the training routings of each model (``ROUTES`` keys)
TRAIN_ROUTES = {"ico2ico": ("", " (merged)", " (chain)", " (chain, merged)",
                            " (chain, fold outside)", " (chain all)", " (chain all, merged)",
                            " (chain all, fold outside)", " (chain dec)"),
                "ico2ico_vae": ("", " (merged)", " (chain)", " (chain all)")}


def planted_for(model: str, route: str):
    if "chain all" in route or "chain dec" in route:
        return PLANTED_N
    return {"": PLANTED[model], " (merged)": PLANTED_MERGED[model]}.get(route) or \
        PLANTED_CHAIN[route]


def one_percent_off(r, path):
    """r with the tensor at the index path (into nested tuples) times 1.01."""
    if not path:
        return r * 1.01
    i, *rest = path
    return (*r[:i], one_percent_off(r[i], rest), *r[i + 1:])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    from geniconet_tpu_torch import bridge
    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit

    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    stats = kernel_vs_plain(card, serving_cases(), "kernel", reps=10)
    train_stats = kernel_vs_plain(card, training_cases(), "train kernel", reps=10)
    for k, v in train_stats.items():
        if k in stats:  # a forward kernel: its main times stay the serving shapes'
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], v["max_abs_err"])
            stats[k]["training_shapes"] = {key: v[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "by_shapes")}
        else:
            stats[k] = v

    vae = "ico2ico_vae"
    serve_vars = {
        "ico2ico": bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=0, random_stats=True),
        vae: bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=0, random_stats=True, model=vae,
                                   latent_features=LATENT),
    }
    launches = {}  # path -> kernel launches in its run
    states = {}
    for model, path in (("ico2ico", "AE serve"), (vae, "VAE serve")):
        build.reset_launches()
        states[model] = {name: serve(model, name, serve_vars[model], card)
                         for name in ("bfloat16", "float32")}
        launches[path] = dict(build.LAUNCHES)
        print(f"[serve {model}] kernel launches on the serving path: {launches[path]}", flush=True)
        check_launches(path, launches[path])
        plain_route_check(states[model]["float32"], card)
        for name, st in states[model].items():
            timings(st, name, card)
    # the AE on the encoder's phase chain (its latent cache goes through m),
    # and the AE and the VAE on both chains (every decode through n too)
    chained = {}
    for model, chain, path in (("ico2ico", "enc", "AE serve (chain)"),
                               ("ico2ico", "1", "AE serve (chain all)"),
                               (vae, "1", "VAE serve (chain all)")):
        build.reset_launches()
        chained[path] = {name: serve(model, name, serve_vars[model], card, phase_chain=chain)
                         for name in ("bfloat16", "float32")}
        launches[path] = dict(build.LAUNCHES)
        print(f"[serve {model} phase_chain={chain!r}] kernel launches on the serving path: "
              f"{launches[path]}", flush=True)
        check_launches(path, launches[path])
        for name, st in chained[path].items():
            chain_cache_check(st, states[model][name], name, card)
            timings(st, name, card)

    t0 = time.perf_counter()
    dataset = synthetic_dataset(SUBDIVISIONS, TRAIN_MESHES, seed=0)
    print(f"[train] {TRAIN_MESHES} synthetic meshes in {time.perf_counter() - t0:.1f} s",
          flush=True)
    train_vars = {
        "ico2ico": bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=1),
        vae: bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=1, model=vae,
                                   latent_features=LATENT),
    }
    runs = {}
    for model in ("ico2ico", vae):
        for route in TRAIN_ROUTES[model]:
            path = f"{'VAE' if model == vae else 'AE'} train{route}"
            runs[path] = {name: train(model, name, train_vars[model], dataset, card, route)
                          for name in ("bfloat16", "float32")}
            launches[path] = dict(sum((collections.Counter(r[-1]) for r in runs[path].values()),
                                      collections.Counter()))
        train_step_check(model, train_vars[model], card,
                         [(route, planted_for(model, route)) for route in TRAIN_ROUTES[model]])
    routing_compare(train_vars, dataset, card)

    profiled = []
    for path, (tr, st, (x, y, wt), _) in ((p, r["bfloat16"]) for p, r in runs.items()):
        route = path.partition(" train")[2].strip(" ()").replace(", ", "_").replace(" ", "_")
        tag = f"train_step_{tr.cfg.model.name}{'_' + route if route else ''}"
        profiled.append((f"{tag}_B{TRAIN_BATCH}",
                         lambda tr=tr, st=st, x=x, y=y, wt=wt: tr.train_step(st, x, y, wt), 5))
    device_profile(serving_workloads(states["ico2ico"]["bfloat16"])
                   + serving_workloads(chained["AE serve (chain)"]["bfloat16"], "_chain", b1=False)
                   + serving_workloads(chained["AE serve (chain all)"]["bfloat16"], "_chain_all")
                   + profiled, card)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)

    def count(k, kind):
        return sum(n.get(k, 0) for path, n in launches.items() if kind in path)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": count(k, "serve") + count(k, "train"),
         "serving_launches": count(k, "serve"), "training_launches": count(k, "train"),
         "launches_by_path": {path: n.get(k, 0) for path, n in launches.items()},
         **stats[k]}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
