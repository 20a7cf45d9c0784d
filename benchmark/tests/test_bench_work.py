"""``benchmark/work.py`` against counts made by hand (CPU)."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import work

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    cfg = json.loads((ROOT / "benchmark/configs/ico2ico.json").read_text())
    cfg["model"]["name"] = name  # the VAE: the same widths, latent 512
    return cfg


def _layers(name, s, B, train):
    return {layer.name: layer for layer in work.layers(_cfg(name), s, B, train)}


def test_one_hex_conv_by_hand():
    # down0's conv01 at s=5, B=36: 128 -> 128 at level 4 (2,560 cells)
    fwd = 2 * 7 * 128 * 128 * 2560 * 36
    eval_ = _layers("ico2ico", 5, 36, False)["encoder.down0.conv01"]
    assert eval_.flops == fwd
    act = 36 * 2560 * 128 * 2  # bf16
    assert eval_.bytes == 2 * act + 7 * 128 * 128 * 2
    train = _layers("ico2ico", 5, 36, True)["encoder.down0.conv01"]
    assert train.flops == 3 * fwd
    # forward x + y + w; taps gradient x + dy (+ f32 dW and db); input gradient dy + w + dx
    assert train.bytes == (2 * act + 7 * 128 * 128 * 2) + (2 * act + 4 * (7 * 128 * 128 + 128)) \
        + (2 * act + 7 * 128 * 128 * 2)


def test_the_upsampling_conv_pair_by_hand():
    # up2's conv00 + conv10 at s=5: 128 -> 64 on the upsampled level-5 grid
    # (10,240 cells), reading the level-4 input (2,560 cells) once
    layer = _layers("ico2ico", 5, 36, False)["decoder.up2.conv00+conv10"]
    assert layer.flops == 2 * (2 * 7 * 128 * 64 * 10240 * 36)
    assert layer.bytes == 2 * (36 * 2560 * 128 + 2 * 36 * 10240 * 64 + 2 * 7 * 128 * 64)


def test_the_heads_by_hand():
    head = _layers("ico2ico", 5, 36, False)["decoder.head"]
    assert head.flops == 2 * 64 * 3 * 10240 * 36
    assert _layers("ico2ico", 5, 36, True)["decoder.head"].flops == 3 * head.flops
    vae = _layers("ico2ico_vae", 5, 36, False)["mu_conv+logvar_conv"]
    assert vae.flops == 2 * (2 * 7 * 256 * 512 * 160 * 36)  # level 2: 160 cells


def test_conv_layers_at_s6_are_four_times_s5():
    for train in (False, True):
        five, six = _layers("ico2ico", 5, 36, train), _layers("ico2ico", 6, 36, train)
        weights = _layers("ico2ico", 5, 0, train)  # a batch of 0 leaves the weights' bytes
        convs = [n for n in five if "conv" in n]
        assert len(convs) == 13
        for n in convs:
            assert six[n].flops == 4 * five[n].flops, n
            w = weights[n].bytes
            assert w > 0 and six[n].bytes - w == 4 * (five[n].bytes - w), n


def test_the_step_totals():
    step = work.step_flops(_cfg("ico2ico"), 5, 36, True)
    fwd = work.step_flops(_cfg("ico2ico"), 5, 36, False)
    assert 1.1e12 < step < 1.15e12 and 3.7e11 < fwd < 3.8e11
    # the least time is a sum of per-layer maxima, never under either total's bound
    least = work.step_least_seconds(_cfg("ico2ico"), 5, 36, True)
    total_bytes = sum(layer.bytes for layer in work.layers(_cfg("ico2ico"), 5, 36, True))
    assert least >= max(step / work.PEAK_FLOPS, total_bytes / work.PEAK_BYTES)
