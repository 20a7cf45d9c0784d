"""Standard-layout hex conv with the BN-apply + ReLU prologue (stride 1).

Port of ``geniconet_tpu/ops/pallas/conv_kernel.py:fused_ico_conv_s2s``,
forward only: ``ico_conv_s2s_fwd`` launches ``csrc/ico_conv.cu`` for a CUDA
tensor and runs ``ico_conv_s2s_fwd_plain`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from geniconet_tpu_torch.ops.conv import ico_conv_s2s
from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels.build import act_apply, check_act, expect, grid_level, on_cuda
from geniconet_tpu_torch.ops.kernels.halo import device_table

__all__ = ["ico_conv_s2s_fwd", "ico_conv_s2s_fwd_plain"]


def ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode="average", act=None):
    """Plain version: act prologue, ``ico_pad``, masked 3×3 conv, fp32 sums."""
    return ico_conv_s2s(act_apply(x, act), taps, bias, grid_level(x.shape[2], x.shape[3]),
                        1, corner_mode)


def ico_conv_s2s_fwd(x, taps, bias, corner_mode: str = "average", act=None) -> torch.Tensor:
    """Stride-1 hex conv (B, 5, h, w, C_in) -> (B, 5, h, w, C_out).

    taps (7, C_in, C_out) and bias (C_out,) or None in x's dtype (float32 or
    bfloat16); act: optional float32 (mul, add), each (C_in,), applied as
    relu(x·mul + add) before the halo."""
    if not on_cuda(x, "ico_conv_s2s_fwd"):
        return ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode, act)
    B, _, h, w, cin = x.shape
    grid_level(h, w)
    cout = taps.shape[-1]
    dev, dt = x.device, x.dtype
    expect(x, (B, 5, h, w, cin), dt, dev, "x")
    expect(taps, (7, cin, cout), dt, dev, "taps")
    if bias is not None:
        expect(bias, (cout,), dt, dev, "bias")
    check_act(act, cin, dev, "ico_conv_s2s_fwd")
    out = torch.empty((B, 5, h, w, cout), dtype=dt, device=dev)
    table = device_table("std", h, w, corner_mode, dev)
    mul, add = act if act is not None else (None, None)
    with torch.cuda.device(dev):
        err = build.library().gn_ico_conv_fwd(
            x.data_ptr(), build.ptr(mul), build.ptr(add), taps.data_ptr(), build.ptr(bias),
            out.data_ptr(), table.data_ptr(), B, h, w, cin, cout, build.dtype_code(dt),
            build.stream_ptr(dev),
        )
    build.check("ico_conv_s2s_fwd", err)
    build.LAUNCHES["ico_conv_s2s_fwd"] += 1
    return out
