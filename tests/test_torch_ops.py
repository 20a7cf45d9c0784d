"""The port's plain ops (geniconet_tpu_torch/ops) against the JAX package.

Data movement must be bit-equal to JAX; the convs and the upsample agree to
1e-5·max|ref| in float32 (only the order of the float32 sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.geometry import ico
from geniconet_tpu.ops import conv as jconv
from geniconet_tpu.ops import pad as jpad
from geniconet_tpu.ops import phase as jphase
from geniconet_tpu.ops import upsample as jup
from geniconet_tpu.ops import vertices as jvert
from geniconet_tpu_torch.ops import conv, pad, phase, upsample, vertices
from geniconet_tpu_torch.ops.kernels import halo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODES = ["average", "zeros"]


def _grid(s, B=2, C=3, seed=0):
    h, w = ico.chart_shape(s)
    return np.random.RandomState(seed).randn(B, 5, h, w, C).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_ico_pad_equal(s, corner_mode):
    x = _grid(s, seed=s)
    np.testing.assert_array_equal(
        pad.ico_pad(_t(x), s, corner_mode).numpy(),
        np.asarray(jpad.ico_pad(jnp.asarray(x), s, corner_mode)))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_padded_index_map_equal(s):
    np.testing.assert_array_equal(pad.padded_index_map(s), jpad.padded_index_map(s))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_split_merge_and_grid_to_vertices_equal(s):
    x = _grid(s, C=4, seed=s)
    g = x.reshape(2, 5 * x.shape[2], x.shape[3], 4)
    np.testing.assert_array_equal(conv.split_charts(_t(g), s).numpy(),
                                  np.asarray(jconv.split_charts(jnp.asarray(g), s)))
    np.testing.assert_array_equal(conv.merge_charts(_t(x)).numpy(),
                                  np.asarray(jconv.merge_charts(jnp.asarray(x))))
    np.testing.assert_array_equal(vertices.grid_to_vertices(_t(g), s).numpy(),
                                  np.asarray(jvert.grid_to_vertices(jnp.asarray(g), s)))


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_phase_split_merge_pad_equal(s, corner_mode):
    x = _grid(s, C=4, seed=10 + s)
    tp, jp = phase.phase_split(_t(x)), jphase.phase_split(jnp.asarray(x))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(phase.phase_merge(tp).numpy(), x)
    for a, b in zip(phase.phase_pad(tp, corner_mode), jphase.phase_pad(jp, corner_mode)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert phase.tap_table(2) == jphase.tap_table(2)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_halo_tables_equal_padded_index_map(s, corner_mode):
    """The kernels' gather tables name the same cells as the JAX package's
    padded_index_map (std table) and phase_pad over an index grid (phase table)."""
    h, w = ico.chart_shape(s)
    P = jpad.padded_index_map(s).copy()
    if corner_mode == "zeros":
        P[P < -1] = halo.ZERO
    P[P == jpad.NORTH_SYNTH] = halo.NORTH
    P[P == jpad.SOUTH_SYNTH] = halo.SOUTH
    want = np.stack([P[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w]
                     for di, dj in jconv.HEX_TAP_OFFSETS]).reshape(7, -1)
    np.testing.assert_array_equal(halo.std_conv_table(h, w, corner_mode), want)

    # phase table: the source id of each cell, through the JAX phase_pad
    hp, wp = h // 2, w // 2
    n = 5 * hp * wp
    ids = tuple(jnp.arange(p * n + 1, (p + 1) * n + 1, dtype=jnp.float32)
                .reshape(1, 5, hp, wp, 1) for p in range(4))
    padded = [np.asarray(a)[0, ..., 0].astype(np.int64) - 1
              for a in jphase.phase_pad(ids, "zeros")]
    if corner_mode == "average":
        padded[2][:, 0, 0], padded[2][:, hp, wp] = halo.NORTH, halo.SOUTH
    want = np.stack([
        np.stack([padded[p_in][:, rs : rs + hp, cs : cs + wp] for p_in, rs, cs
                  in jphase.tap_table(p_out)]) for p_out in range(4)]).reshape(4, 7, n)
    np.testing.assert_array_equal(halo.phase_conv_table(hp, wp, corner_mode), want)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_ico_conv_s2s(s, stride, corner_mode):
    x = _grid(s, C=5, seed=20 + s)
    r = np.random.RandomState(1)
    taps = r.randn(7, 5, 6).astype(np.float32)
    bias = r.randn(6).astype(np.float32)
    got = conv.ico_conv_s2s(_t(x), _t(taps), _t(bias), s, stride, corner_mode)
    ref = jconv.ico_conv_s2s(jnp.asarray(x), jnp.asarray(taps), jnp.asarray(bias), s,
                             stride, corner_mode)
    _close(got.numpy(), ref)
    kern = jconv.taps_to_kernel(jnp.asarray(taps))
    np.testing.assert_array_equal(conv.taps_to_kernel(_t(taps)).numpy(), np.asarray(kern))


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_ico_upsample(s, corner_mode):
    x = _grid(s, C=4, seed=30 + s)
    _close(upsample.ico_upsample_s2s(_t(x), s, corner_mode).numpy(),
           jup.ico_upsample_s2s(jnp.asarray(x), s, corner_mode))


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3])
def test_phase_conv_both_strides(s, corner_mode):
    x = _grid(s, C=4, seed=40 + s)
    r = np.random.RandomState(2)
    taps, bias = r.randn(7, 4, 3).astype(np.float32), r.randn(3).astype(np.float32)
    for out_phases in [(0, 1, 2, 3), (2,)]:
        got = phase.phase_conv(phase.phase_split(_t(x)), _t(taps), _t(bias), corner_mode,
                               out_phases)
        ref = jphase.phase_conv(jphase.phase_split(jnp.asarray(x)), jnp.asarray(taps),
                                jnp.asarray(bias), corner_mode, out_phases)
        for a, b in zip(got, ref):
            _close(a.numpy(), b)
