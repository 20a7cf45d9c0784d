"""The work of one step, per model layer, from the configuration's shapes.

A model layer is a hex conv with the BatchNorm and ReLU around it (the two
convs of a residual block that read the same input count as one layer,
reading it once), the 1x1 head, the loss and Adam. Its operations are
the model's own: 2·7·C_in·C_out multiply-adds per output cell for a hex
conv, at the level of its output (an UpBlock's convs at the level they
produce, on the upsampled grid); a training step counts the forward, the
input gradient and the taps gradient of each conv (3x the forward; the
first conv's input is data, so it has no input gradient), and never a
recomputation. Bytes count each input, weight and output of a layer once:
activations and weights in the compute dtype, gradients of the weights,
the optimizer state and the loss's float32 tensors at 4 bytes. Whatever
kernels implement a layer, fused, split or renamed, its count stays.

The least time a layer could take on the card is the larger of its
operations over the peak rate and its bytes over the peak bandwidth
(``least_seconds``). Peaks: NVIDIA's H100 SXM data sheet, dense bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from benchmark.reference import model as M

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def cells(level: int) -> int:
    """Grid cells at a level (the two poles are derived from them)."""
    return 10 * 4**level


@dataclass(frozen=True)
class Layer:
    name: str
    flops: float
    bytes: float

    def least_seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def _conv_layer(name, B, a, lin, cin, lout, cout, n, train, has_dx=True):
    """n hex convs (C_in -> C_out) reading one level-``lin`` input,
    producing level-``lout`` outputs."""
    x, y = B * cells(lin) * cin, n * B * cells(lout) * cout
    w = n * 7 * cin * cout
    f = 2.0 * 7 * cin * cout * cells(lout) * B * n
    flops, byts = f, a * (x + y + w)
    if train:
        flops += f  # taps gradient
        byts += a * (x + y) + 4 * (w + n * cout)
        if has_dx:
            flops += f  # input gradient
            byts += a * (y + x + w)
    return Layer(name, flops, byts)


def layers(cfg: dict, s: int, B: int, train: bool) -> list[Layer]:
    """The model layers of one step of ``cfg``'s model at level s over a
    batch of B: a training step (forward, backward, loss, Adam) or an
    eval-mode forward."""
    m = cfg["model"]
    a = DTYPE_BYTES[m["compute_dtype"]]
    w0, w1, w2 = m["widths"]
    vae = m["name"].endswith("_vae")
    out = [_conv_layer("encoder.conv_in", B, a, s, 3, s, w0, 1, train, has_dx=False)]
    downs = (w0, w1, w2) if vae else (w0, w1, w2, w2)
    for k, (cin, cout) in enumerate(zip(downs[:-1], downs[1:])):
        out.append(_conv_layer(f"encoder.down{k}.conv00+conv10", B, a, s - k, cin, s - k - 1,
                               cout, 2, train))
        out.append(_conv_layer(f"encoder.down{k}.conv01", B, a, s - k - 1, cout, s - k - 1,
                               cout, 1, train))
    zc = w2
    if vae:
        zc = m["latent_features"]
        out.append(_conv_layer("mu_conv+logvar_conv", B, a, s - 2, w2, s - 3, zc, 2, train))
        n = B * cells(s - 3) * zc
        # z = mu + eps·exp(logvar/2): reads mu, logvar and eps, writes z
        out.append(Layer("reparameterize", 3.0 * n, (a * 3 + 4) * n))
    ups = ((zc, w2), (w2, w1), (w1, w0))
    for k, (cin, cout) in enumerate(ups):
        lin = s - 3 + k
        out.append(_conv_layer(f"decoder.up{k}.conv00+conv10", B, a, lin, cin, lin + 1, cout, 2,
                               train))
        out.append(_conv_layer(f"decoder.up{k}.conv01", B, a, lin + 1, cout, lin + 1, cout, 1,
                               train))
    # head: 1x1 conv w0 -> 3 and tanh; eval writes the float32 grid
    n_in, n_out = B * cells(s) * w0, B * cells(s) * 3
    f = 2.0 * w0 * 3 * cells(s) * B
    if train:  # forward, input and weight gradients; reads its input, writes that gradient
        out.append(Layer("decoder.head", 3 * f, a * 2 * n_in + a * w0 * 3 + 4 * (w0 + 1) * 3))
    else:
        out.append(Layer("decoder.head", f, a * n_in + 4 * n_out + a * w0 * 3))
    if train:
        V = cells(s) + 2
        used = 9 if vae else 3  # the target channels the loss reads
        out.append(Layer("loss", 5.0 * B * V * used, 4.0 * B * V * used))
        n_params = sum(
            math.prod(shape) for _, shape, kind, _ in M.param_specs(m["name"], m["widths"],
                                                                     m["latent_features"])
            if kind not in ("bn_mean", "bn_var"))
        # Adam reads and writes the parameters and both moments
        out.append(Layer("adam", 10.0 * n_params, 4.0 * 6 * n_params))
    return out


def step_flops(cfg: dict, s: int, B: int, train: bool) -> float:
    return sum(layer.flops for layer in layers(cfg, s, B, train))


def step_least_seconds(cfg: dict, s: int, B: int, train: bool) -> float:
    return sum(layer.least_seconds() for layer in layers(cfg, s, B, train))
