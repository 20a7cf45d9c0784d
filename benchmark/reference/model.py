"""The icosahedral autoencoder (ico2ico) and VAE (ico2ico_vae) in plain
float32 PyTorch: the halo padding, the hexagonal conv, the upsample,
BatchNorm, the residual blocks, the 1x1 head and the VAE's heads, written
from the published architecture, with no kernel, cache or batching of the
program under test.

Parameters are a flat dict of float32 tensors under the names that
``param_specs`` lists; the benchmark makes one set from the seed and hands
the same values to the program and to this reference.

Layout: a level-s grid is ``(B, 5·2^s, 2^(s+1), C)``; the blocks work on
its chart-split form ``(B, 5, 2^s, 2^(s+1), C)``. After the halo pad the
7-tap hex stencil is a 3x3 conv whose (-1,-1) and (+1,+1) taps are zero;
the stride-2 conv (level s -> s-1) is the same conv over the padded grid
without its first row, at stride 2.

``q``: a rounding applied where the program under test stores a tensor in
its compute dtype (each conv's input, taps and output). The identity gives
the float32 reference; ``reference/quant.py`` gives the lower-precision
control.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as geo

HEX_TAPS = ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0))
_TAP_INDEX = [(di + 1) * 3 + (dj + 1) for di, dj in HEX_TAPS]
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # the share of itself a running statistic keeps each step (torch's 0.1)


def identity(x):
    return x


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convs without TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def param_specs(model: str, widths, latent_features: int = 512):
    """[(name, shape, kind, fan_in)] of every parameter and BatchNorm
    statistic; kind is conv_taps, conv_bias, head_kernel, head_bias,
    bn_scale, bn_bias, bn_mean or bn_var."""
    w0, w1, w2 = widths
    out = []

    def conv(name, cin, cout):
        out.append((f"{name}.taps", (7, cin, cout), "conv_taps", 7 * cin))
        out.append((f"{name}.bias", (cout,), "conv_bias", 7 * cin))

    def bn(name, c):
        for leaf in ("scale", "bias", "mean", "var"):
            out.append((f"{name}.{leaf}", (c,), f"bn_{leaf}", 0))

    def block(name, cin, cout):
        conv(f"{name}.conv00", cin, cout)
        conv(f"{name}.conv10", cin, cout)
        conv(f"{name}.conv01", cout, cout)
        for b in ("bn00", "bn01", "bn10"):
            bn(f"{name}.{b}", cout)

    vae = model.endswith("_vae")
    conv("encoder.conv_in", 3, w0)
    bn("encoder.bn_in", w0)
    downs = (w0, w1, w2) if vae else (w0, w1, w2, w2)
    for k, (cin, cout) in enumerate(zip(downs[:-1], downs[1:])):
        block(f"encoder.down{k}", cin, cout)
    if vae:
        for head in ("mu", "logvar"):
            conv(f"{head}_conv", w2, latent_features)
            bn(f"{head}_bn", latent_features)
    ups = ((latent_features if vae else w2, w2), (w2, w1), (w1, w0))
    for k, (cin, cout) in enumerate(ups):
        block(f"decoder.up{k}", cin, cout)
    out.append(("decoder.head.kernel", (w0, 3), "head_kernel", w0))
    out.append(("decoder.head.bias", (3,), "head_bias", w0))
    return out


def split_charts(x: torch.Tensor, s: int) -> torch.Tensor:
    h, w = geo.chart_shape(s)
    return x.reshape(x.shape[0], 5, h, w, x.shape[-1])


def merge_charts(x: torch.Tensor) -> torch.Tensor:
    B, n, h, w, C = x.shape
    return x.reshape(B, n * h, w, C)


def chart_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the chart axis (dim 1)."""
    return t.mean(dim=1)


def ico_pad(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, 5, h, w, C) -> (B, 5, h+2, w+2, C): each chart with its one-cell
    halo from the neighbouring charts, the pole cells the mean of the five
    charts' corner cells ('average' corners), never-read corners zero."""
    h, w = geo.chart_shape(s)
    B, _, _, _, C = x.shape
    up = torch.roll(x, shifts=-1, dims=1)  # chart c+1 seen from chart c
    dn = torch.roll(x, shifts=1, dims=1)   # chart c-1

    def swap(t):
        return t.transpose(2, 3)

    pole_n = chart_mean(x[:, :, 0, 0, :])[:, None, None, None, :].expand(B, 5, 1, 1, C)
    pole_s = chart_mean(x[:, :, h - 1, w - 1, :])[:, None, None, None, :].expand(B, 5, 1, 1, C)
    zero = x.new_zeros((B, 5, 1, 1, C))
    top = torch.cat([zero, pole_n, swap(up[:, :, 0:h, 0:1]), up[:, :, h - 1 : h, 1 : h + 1]],
                    dim=3)
    bottom = torch.cat([dn[:, :, 0:1, h - 1 : w], swap(dn[:, :, 0:h, w - 1 : w]), zero], dim=3)
    left = swap(dn[:, :, 0:1, 0:h])
    right = torch.cat([swap(up[:, :, h - 1 : h, h + 1 : w]), pole_s], dim=2)
    mid = torch.cat([left, x, right], dim=3)
    return torch.cat([top, mid, bottom], dim=2)


def hex_conv(x, taps, bias, s: int, stride: int = 1, q=identity) -> torch.Tensor:
    """(B, 5, h, w, Cin) at level s -> level s (stride 1) or s-1 (stride 2)."""
    x, taps = q(x), q(taps)
    padded = ico_pad(x, s)
    if stride == 2:
        padded = padded[:, :, 1:]
    B, n, hp, wp, cin = padded.shape
    cout = taps.shape[-1]
    idx = torch.tensor(_TAP_INDEX, device=taps.device)
    kernel = taps.new_zeros((9, cin, cout)).index_copy(0, idx, taps)
    kernel = kernel.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    flat = padded.reshape(B * n, hp, wp, cin).permute(0, 3, 1, 2)
    out = F.conv2d(flat, kernel, bias, stride=stride).permute(0, 2, 3, 1)
    return q(out.reshape(B, n, *out.shape[1:]))


def upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Level s -> s+1: old vertices carried over, new ones the midpoints of
    row, column and anti-diagonal edges (read through the halo)."""
    h, w = geo.chart_shape(s)
    P = ico_pad(x, s)
    oo = P[:, :, 1 : h + 1, 1 : w + 1]
    ee = (P[:, :, 0:h, 1 : w + 1] + oo) * 0.5
    oq = (oo + P[:, :, 1 : h + 1, 2 : w + 2]) * 0.5
    eq = (oo + P[:, :, 0:h, 2 : w + 2]) * 0.5
    B, n, _, _, C = x.shape
    even = torch.stack([ee, eq], dim=4).reshape(B, n, h, 2 * w, C)
    odd = torch.stack([oo, oq], dim=4).reshape(B, n, h, 2 * w, C)
    return torch.stack([even, odd], dim=3).reshape(B, n, 2 * h, 2 * w, C)


class Recording(dict):
    """Parameters under which every BatchNorm in train mode keeps the
    batch's moments in ``moments`` (name -> (mean, var))."""

    def __init__(self, params: dict):
        super().__init__(params)
        self.moments = {}


def batch_norm(y: torch.Tensor, p: dict, name: str, train: bool) -> torch.Tensor:
    """BatchNorm over every axis but the channels: the batch's biased
    moments in train mode, the running statistics in eval mode."""
    if train:
        dims = tuple(range(y.dim() - 1))
        mean = y.mean(dim=dims)
        var = y.var(dim=dims, unbiased=False)
        if isinstance(p, Recording):
            p.moments[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    return (y - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"] + p[f"{name}.bias"]


def _conv(p, name, x, s, stride, q):
    return hex_conv(x, p[f"{name}.taps"], p[f"{name}.bias"], s, stride, q)


def block(p: dict, name: str, x, s: int, stride: int, train: bool, q=identity):
    """relu(bn01(conv01(relu(bn00(conv00(x))))) + bn10(conv10(x))); x at
    level s, the output at level s (stride 1) or s-1 (stride 2)."""
    b0 = torch.relu(batch_norm(_conv(p, f"{name}.conv00", x, s, stride, q), p, f"{name}.bn00",
                               train))
    so = s if stride == 1 else s - 1
    b0 = batch_norm(_conv(p, f"{name}.conv01", b0, so, 1, q), p, f"{name}.bn01", train)
    y10 = batch_norm(_conv(p, f"{name}.conv10", x, s, stride, q), p, f"{name}.bn10", train)
    return torch.relu(b0 + y10)


def encoder(p: dict, x: torch.Tensor, s: int, n_down: int, train: bool, q=identity):
    """Grid (B, 5·2^s, 2^(s+1), 3) -> chart-split features at level s-n_down."""
    y = _conv(p, "encoder.conv_in", split_charts(x, s), s, 1, q)
    y = torch.relu(batch_norm(y, p, "encoder.bn_in", train))
    for k in range(n_down):
        y = block(p, f"encoder.down{k}", y, s - k, 2, train, q)
    return y


def decoder(p: dict, z: torch.Tensor, s_latent: int, train: bool, q=identity):
    """Chart-split latent at level s_latent -> grid (B, 5·2^s, 2^(s+1), 3),
    s = s_latent + 3, float32."""
    y = z
    for k in range(3):
        y = block(p, f"decoder.up{k}", upsample(y, s_latent + k), s_latent + k + 1, 1, train, q)
    out = torch.tanh(q(y) @ p["decoder.head.kernel"] + p["decoder.head.bias"])
    return merge_charts(out)


def autoencoder(p: dict, x: torch.Tensor, s: int, train: bool, q=identity) -> torch.Tensor:
    """The AE's reconstruction of the grids x."""
    return decoder(p, encoder(p, x, s, 3, train, q), s - 3, train, q)


def vae_encode(p: dict, x: torch.Tensor, s: int, train: bool, q=identity):
    """(mu, logvar), chart-split at level s-3: the trunk (conv_in and two
    DownBlocks), then a stride-2 conv and a BatchNorm each, no ReLU."""
    feat = encoder(p, x, s, 2, train, q)
    mu = batch_norm(_conv(p, "mu_conv", feat, s - 2, 2, q), p, "mu_bn", train)
    logvar = batch_norm(_conv(p, "logvar_conv", feat, s - 2, 2, q), p, "logvar_bn", train)
    return mu, logvar


def vae(p: dict, x: torch.Tensor, s: int, train: bool, eps=None, q=identity):
    """(reconstruction, mu, logvar); the decoder reads mu + eps·exp(logvar/2)
    with eps given in the public latent layout (B, 5·2^(s-3), 2^(s-2), wz),
    or mu when eps is None."""
    mu, logvar = vae_encode(p, x, s, train, q)
    z = mu if eps is None else mu + split_charts(eps, s - 3) * torch.exp(0.5 * logvar)
    return decoder(p, z, s - 3, train, q), merge_charts(mu), merge_charts(logvar)
