"""The port at subdivisions 6 and 7 against the JAX package, on the CPU.

The model and the tables are generic in s; these tests hold what the
kernels read at s=6 and s=7 (the stretch config: s=7 is 163,842 vertices,
a (640, 256) grid) without running a kernel:

* the kernels' gather tables (``ops/kernels/halo.py``) name the cells of the
  JAX package's ``padded_index_map`` and ``phase_pad``, and the port's pad
  gathers (``ico_pad``, ``phase_pad``) equal the JAX ones bit for bit, at
  every level an s=6 or s=7 model reads (5 to 7 here; tests/test_torch_ops.py
  holds 1 to 4);
* an s=6 AE eval forward at widths (2, 3, 4), B=1, every block on the
  kernels' plain versions, against flax ``IcoAE(use_pallas=False)`` with
  the same weights (``bridge.py``), to 1e-4·max|ref| in float32;
* the shapes of the latent and the output at s=7, as
  ``tests/test_parallel.py:test_subdivision_scaling_shapes`` holds them for
  JAX: the plain route at full width on the meta device (no FLOPs), the
  kernels' route at widths (2, 3, 4) on the CPU;
* the up convs' plain dx, whose autograd graph goes over groups of samples
  at s=7's batch, gives the whole graph's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.geometry import ico as jico
from geniconet_tpu.nn.models import IcoAE as FlaxIcoAE
from geniconet_tpu.ops import conv as jconv
from geniconet_tpu.ops import pad as jpad
from geniconet_tpu.ops import phase as jphase
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.geometry import ico
from geniconet_tpu_torch.nn.models import IcoAE
from geniconet_tpu_torch.ops import pad, phase
from geniconet_tpu_torch.ops.kernels import halo

MODES = ["average", "zeros"]


def _grid(level, C=2, seed=0):
    h, w = ico.chart_shape(level)
    return np.random.RandomState(seed).randn(1, 5, h, w, C).astype(np.float32)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("level", [5, 6, 7])
def test_halo_tables_equal_the_jax_pads(level, corner_mode):
    """The standard conv's table against ``padded_index_map`` and the phase
    conv's against ``phase_pad`` over an index grid, as
    tests/test_torch_ops.py holds them at levels 1-4; and the port's
    ``padded_index_map`` is the JAX one."""
    h, w = ico.chart_shape(level)
    P = jpad.padded_index_map(level).copy()
    np.testing.assert_array_equal(pad.padded_index_map(level), P)
    if corner_mode == "zeros":
        P[P < -1] = halo.ZERO
    P[P == jpad.NORTH_SYNTH] = halo.NORTH
    P[P == jpad.SOUTH_SYNTH] = halo.SOUTH
    want = np.stack([P[:, 1 + di : 1 + di + h, 1 + dj : 1 + dj + w]
                     for di, dj in jconv.HEX_TAP_OFFSETS]).reshape(7, -1)
    np.testing.assert_array_equal(halo.std_conv_table(h, w, corner_mode), want)

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
@pytest.mark.parametrize("level", [6, 7])
def test_pad_gathers_equal_the_jax_ones(level, corner_mode):
    x = _grid(level, seed=level)
    np.testing.assert_array_equal(
        pad.ico_pad(torch.from_numpy(x), level, corner_mode).numpy(),
        np.asarray(jpad.ico_pad(jnp.asarray(x), level, corner_mode)))
    tp, jp = phase.phase_split(torch.from_numpy(x)), jphase.phase_split(jnp.asarray(x))
    for a, b in zip(phase.phase_pad(tp, corner_mode), jphase.phase_pad(jp, corner_mode),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_s6_eval_forward_matches_flax():
    s, widths = 6, (2, 3, 4)
    variables = bridge.init_variables(s, widths, seed=3, random_stats=True)
    x = np.random.RandomState(1).uniform(-1, 1, (1, *jico.grid_shape(s), 3)).astype(np.float32)
    ref = FlaxIcoAE(subdivisions=s, widths=widths, use_pallas=False).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    m = IcoAE(s, widths)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (1, *ico.grid_shape(s), 3)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("route", ["plain, full width, meta", "kernels, widths (2, 3, 4)"])
def test_s7_shapes(route):
    """The plain route at the default widths on the meta device (shapes
    only, as JAX's ``eval_shape``), and the kernels' route at B=1 on the
    CPU's plain versions (the wrappers take no meta tensor), finite."""
    s = 7
    H, W = ico.grid_shape(s)
    assert (H, W) == (640, 256) and ico.num_vertices(s) == 163_842
    if route.startswith("plain"):
        B, widths, kw = 2, (64, 128, 256), dict(pallas_blocks="none", device="meta")
        x = torch.empty(B, H, W, 3, device="meta")
    else:
        B, widths, kw = 1, (2, 3, 4), {}
        x = torch.rand(B, H, W, 3, generator=torch.Generator().manual_seed(0))
    m = IcoAE(s, widths, **kw)
    with torch.no_grad():
        z = m.encode(x)
        out = m.decode(z)
    assert z.shape == (B, 5 * 2 ** (s - 3), 2 ** (s - 2), widths[2])
    assert out.shape == (B, H, W, 3)
    if x.device.type == "cpu":
        assert bool(torch.isfinite(out).all())


def flat_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat_tensors(o)]


@pytest.mark.parametrize("kernel", ["up_dual_conv_dx", "up_pair_dx"])
def test_up_adjoint_in_sample_groups_equals_one_graph(kernel, monkeypatch):
    """The up convs' plain dx takes its autograd graph over groups of
    samples where a batch passes ``_ADJOINT_CELLS`` (an s=7 batch of 36):
    each sample's dx is its own, so groups of 2 give the whole graph's
    bits."""
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    gen = torch.Generator().manual_seed(0)
    B, h, w, cin, cout = 5, 4, 8, 6, 5

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    g = [[rnd(B, 5, h, w, cout) for _ in range(4)] for _ in range(2)]
    sets = [(rnd(7, cin, cout), None) for _ in range(2)]
    if kernel == "up_dual_conv_dx":
        def call():
            return pk.up_dual_conv_dx_plain(g, sets, "average", torch.float32)[0]
    else:
        b0, y10 = [rnd(B, 5, h // 2, w // 2, cin) for _ in range(4)], \
            [rnd(B, 5, h // 2, w // 2, cin) for _ in range(4)]
        aff = tuple(rnd(cin) for _ in range(4))

        def call():
            return pk.up_pair_dx_plain(g, b0, y10, aff, sets, "average")[:2]
    whole = call()
    monkeypatch.setattr(pk, "_ADJOINT_CELLS", 2 * 5 * h * w)
    for a, b in zip(flat_tensors(whole), flat_tensors(call()), strict=True):
        assert torch.equal(a, b)
