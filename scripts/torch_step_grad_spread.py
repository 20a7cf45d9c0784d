#!/usr/bin/env python3
"""How far one-ulp rounding flips in a bf16 forward move a training step's gradients.

    python3 scripts/torch_step_grad_spread.py

Runs the bf16 training step of the card tests (``_bf16_step`` of
``tests/test_torch_cuda.py``: the s=4 AE and VAE, widths 8/16/16, B=4, the
default route) on one CUDA GPU, with some forward wrappers patched to their
plain versions on the card tensors, and prints, for each pair of steps that
differ in one forward only, the share of that forward's bf16 outputs that
differ between the two on the same inputs (in the step with every kernel;
each output is within one bf16 ulp), the two losses, and the five
gradients farthest apart, each as max|a - b| over max|b| (a conv bias over
its taps' scale). The pairs: the grid convs' forward (``phase_conv_fwd`` and
``ico_conv_s2s_fwd``) kernel against plain, each of the two alone, the up
conv's forward (``up_dual_conv_fwd``) kernel against plain, and the grid
convs' plain forward with its sums in float64 (then rounded once to bf16)
against the plain forward with float32 sums: two correct roundings.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

GRID = ("phase_conv_fwd", "ico_conv_s2s_fwd")


def bf16_outputs(out):
    if isinstance(out, torch.Tensor):
        return [out] if out.dtype == torch.bfloat16 else []
    return [t for o in out or () for t in bf16_outputs(o)]


def counting(fn, other, flips):
    """fn, also counting its bf16 outputs that differ from other's on the
    same inputs into flips[fn's name] = [differing, all]."""
    def call(*args):
        got = fn(*args)
        for g, r in zip(bf16_outputs(got), bf16_outputs(other(*args))):
            flips[fn.__name__][0] += int((g != r).sum())
            flips[fn.__name__][1] += g.numel()
        return got
    call.__name__ = fn.__name__
    return call


def plain64():
    """The grid forwards' plain versions with their sums in float64, then
    rounded to the dtype once."""
    from geniconet_tpu_torch.ops.conv import ico_conv_s2s
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
    from geniconet_tpu_torch.ops.phase import phase_conv

    def phase_conv_fwd(phases, tap_sets, corner_mode="average", out_phases=(0, 1, 2, 3),
                       act=None, with_stats=False):
        xs = [build.act_apply(p, act).double() for p in phases]
        sets = [tuple(o.to(phases[0].dtype) for o in phase_conv(
            xs, t.double(), None if b is None else b.double(), corner_mode, out_phases))
            for t, b in tap_sets]
        return (sets, [pk.stats_plain(o) for o in sets]) if with_stats else sets

    def ico_conv_s2s_fwd(x, taps, bias, corner_mode="average", act=None, with_stats=False):
        out = ico_conv_s2s(build.act_apply(x, act).double(), taps.double(),
                           None if bias is None else bias.double(),
                           build.grid_level(x.shape[2], x.shape[3]), 1, corner_mode).to(x.dtype)
        return (out, pk.stats_plain([out])) if with_stats else out

    return phase_conv_fwd, ico_conv_s2s_fwd


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_grad_spread: needs a CUDA GPU")
    import test_torch_cuda as t
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import fused
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    module = {"phase_conv_fwd": pk, "ico_conv_s2s_fwd": ck, "up_dual_conv_fwd": pk}
    cuda = torch.device("cuda")

    def step(model, plain=(), counted=(), flips=None):
        """_bf16_step with ``plain`` wrappers on their plain versions and the
        ``counted`` kernels' flips against their plain versions counted."""
        with contextlib.ExitStack() as stack:
            for name in counted:
                kernel = getattr(module[name], name)
                plain_fn = getattr(module[name], f"{name}_plain")
                stack.enter_context(mock.patch.object(fused, name,
                                                      counting(kernel, plain_fn, flips)))
            loss, _, grads = t._bf16_step(cuda, model, plain=plain)
        return loss, grads

    p64, s64 = plain64()
    for model in ("ico2ico", "ico2ico_vae"):
        pairs = []
        flips = collections.defaultdict(lambda: [0, 0])
        kernels = step(model, counted=(*GRID, "up_dual_conv_fwd"), flips=flips)
        no_grid = step(model, plain=GRID)
        pairs.append(("grid forwards, kernel against plain", GRID, kernels, no_grid))
        pairs.append(("phase conv alone", GRID[:1], step(model, plain=GRID[1:]), no_grid))
        pairs.append(("standard conv alone", GRID[1:], step(model, plain=GRID[:1]), no_grid))
        pairs.append(("up conv, kernel against plain", ("up_dual_conv_fwd",), kernels,
                      step(model, plain="up_dual_conv_fwd")))
        flips64 = collections.defaultdict(lambda: [0, 0])
        p64.__name__, s64.__name__ = GRID
        with mock.patch.object(pk, "phase_conv_fwd_plain", counting(
                p64, pk.phase_conv_fwd_plain, flips64)), \
                mock.patch.object(ck, "ico_conv_s2s_fwd_plain", counting(
                    s64, ck.ico_conv_s2s_fwd_plain, flips64)):
            sum64 = step(model, plain=GRID)
        for what, names, (loss, grads), (ref_loss, ref) in pairs:
            flipped, total = map(sum, zip(*(flips[n] for n in names)))
            print(f"[grad spread] {model} {what}: {flipped} of {total} bf16 outputs differ "
                  f"({flipped / total:.3e}); loss {loss:.6g} against {ref_loss:.6g}; worst "
                  f"gradients {t._step_rel(grads, ref)[:5]} [{card}]", flush=True)
        (loss, grads), (ref_loss, ref) = sum64, no_grid
        flipped, total = map(sum, zip(*flips64.values()))
        print(f"[grad spread] {model} grid forwards, float64 sums against float32 sums (both "
              f"plain): {flipped} of {total} bf16 outputs differ ({flipped / total:.3e}); loss "
              f"{loss:.6g} against {ref_loss:.6g}; worst gradients "
              f"{t._step_rel(grads, ref)[:5]} [{card}]", flush=True)


if __name__ == "__main__":
    main()
