"""The bf16 tensor-core forward of the up conv and of kernel n, as its GEMM
formulates it, on the CPU: the upsampled operand's rows gathered through the
conv table, times the taps packed side by side, plus the bias; and the work
split of its grid (``build.mma_fwd_grid``, ``build.packed_taps_shape``).

``_rows_fwd`` replays in plain PyTorch what ``csrc/mma_conv_fwd.cuh``
computes: output row q = (sample b, output phase slot, cell m) is
sum_t U[row_t(q)] @ W[t] + bias, where ``row_t`` reads
``halo.phase_conv_table`` (a cell of the sample's 4·5hw upsampled phase
cells; NORTH / SOUTH the sample's two pole rows after them; ZERO the zero
row after the last sample) and W is both tap sets packed into (7·Kp, Np)
with zeros past C_in and past the columns. Its outputs are cast to the
dtype and its stats are taken of the cast outputs. It is held against the
wrappers' plain versions (``up_dual_conv_fwd_plain``, ``up_pair_fwd_plain``:
the ``ico_pad`` / midpoint / phase-pad ops) at s=1-4, both corner modes, in
float32 (1e-5·max|ref|: only the order of the float32 sums differs) and in
bfloat16 (TOL 2e-2·max|ref|: the float32 sums round to bf16 at different
points), and against the JAX package's ``fused_up_dual_conv`` and
``fused_up_dual_conv_pair`` in Pallas interpret mode at one tiny shape
(float32, 1e-5). Inputs come from numpy seeds.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import build, halo
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _packed_taps(tap_sets, cin):
    """Both tap sets side by side, as the kernel's tap pack writes them:
    row t·Kp + k, column set·C_out + c, zeros past C_in and past the
    columns; float32 (the pack copies the dtype's values)."""
    cout = tap_sets[0][0].shape[-1]
    rows, cols = build.packed_taps_shape(cin, len(tap_sets) * cout)
    kp = rows // 7
    packed = torch.zeros(7, kp, cols)
    for s, (taps, _) in enumerate(tap_sets):
        packed[:, :cin, s * cout : (s + 1) * cout] = taps.float()
    return packed


def _rows_fwd(rows, B, h, w, tap_sets, corner_mode, dtype, with_stats=False):
    """The GEMM's formulation: ``rows`` the (B·(4·5hw + 2) + 1, width)
    operand; per set the 4 output phases (B, 5, h, w, C_out) in ``dtype``,
    with the per-set [Σy, Σy²] of the cast outputs."""
    M, width = 5 * h * w, rows.shape[1]
    cin, cout = tap_sets[0][0].shape[1], tap_sets[0][0].shape[-1]
    per = 4 * M + 2
    table = torch.from_numpy(halo.phase_conv_table(h, w, corner_mode)).long()  # (4, 7, M)
    base = (torch.arange(B) * per).view(B, 1, 1, 1)
    idx = torch.where(table >= 0, base + table,
                      torch.where(table == halo.ZERO, torch.tensor(B * per),
                                  base + 4 * M + (table == halo.SOUTH).long()))  # (B, 4, 7, M)
    gathered = rows.float()[idx]  # (B, 4, 7, M, width)
    packed = _packed_taps(tap_sets, cin)[:, :width]  # (7, width, Np)
    acc = torch.einsum("bptmk,tkn->bpmn", gathered, packed)
    sets, stats = [], []
    for s, (_, bias) in enumerate(tap_sets):
        y = acc[..., s * cout : (s + 1) * cout]
        if bias is not None:
            y = y + bias.float()
        y = y.to(dtype).reshape(B, 4, 5, h, w, cout)
        sets.append(tuple(y[:, p] for p in range(4)))
        stats.append(pk.stats_plain(sets[-1]))
    return (sets, stats) if with_stats else sets


def _close(got, ref, tol):
    got, ref = (t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t, np.float32)) for t in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


def _close_tree(got, ref, tol):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close_tree(a, b, tol)
    else:
        _close(got, ref, tol)


def _grid(r, B, s, c):
    return torch.from_numpy(r.randn(B, 5, 2**s, 2 ** (s + 1), c).astype(np.float32))


def _sets(r, cin, cout, n_sets, dtype):
    return [(torch.from_numpy((r.randn(7, cin, cout) * (7 * cin) ** -0.5).astype(np.float32))
             .to(dtype), torch.from_numpy(r.randn(cout).astype(np.float32)).to(dtype))
            for _ in range(n_sets)]


def _pair(r, B, s, cin, dtype):
    b0 = [_grid(r, B, s - 1, cin).to(dtype) for _ in range(4)]
    y10 = [_grid(r, B, s - 1, cin).to(dtype) for _ in range(4)]
    aff = [torch.from_numpy(a.astype(np.float32)) for a in (
        r.uniform(0.5, 1.5, cin), 0.3 * r.randn(cin), r.uniform(0.5, 1.5, cin),
        0.3 * r.randn(cin))]
    return b0, y10, aff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout, n_sets", [(1, 5, 6, 2), (2, 12, 20, 2), (3, 16, 9, 1),
                                                  (4, 8, 4, 2)])
def test_rows_fwd_is_the_up_conv(s, cin, cout, n_sets, corner_mode, dtype):
    """The gathered-rows GEMM on ``up_operand_plain`` of a level-s grid is
    ``up_dual_conv_fwd_plain``, outputs and stats."""
    r = np.random.RandomState(40 + s)
    x = _grid(r, 2, s, cin).to(dtype)
    sets = _sets(r, cin, cout, n_sets, dtype)
    h, w = 2**s, 2 ** (s + 1)
    got = _rows_fwd(pk.up_operand_plain(x, corner_mode), 2, h, w, sets, corner_mode, dtype, True)
    ref = pk.up_dual_conv_fwd_plain(x, sets, corner_mode, True)
    assert all(o.dtype == dtype for group in got[0] for o in group)
    _close_tree(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s, cin, cout", [(1, 3, 4), (2, 12, 20), (3, 8, 6), (4, 5, 8)])
def test_rows_fwd_is_the_pair_conv(s, cin, cout, corner_mode, dtype):
    """The same GEMM on ``up_pair_operand_plain`` (the pair joined once) is
    ``up_pair_fwd_plain``, outputs and stats."""
    r = np.random.RandomState(50 + s)
    b0, y10, aff = _pair(r, 2, s, cin, dtype)
    sets = _sets(r, cin, cout, 2, dtype)
    h, w = 2**s, 2 ** (s + 1)
    rows = pk.up_pair_operand_plain(b0, y10, aff, corner_mode)
    got = _rows_fwd(rows, 2, h, w, sets, corner_mode, dtype, True)
    _close_tree(got, pk.up_pair_fwd_plain(b0, y10, aff, sets, corner_mode, True), TOL[dtype])


def _j(*arrs):
    return [jnp.asarray(a.numpy()) for a in arrs]


def test_rows_fwd_matches_pallas_interpret(interpret):
    """The formulation against ``fused_up_dual_conv`` with stats
    (``_up_fwd_kernel``) in interpret mode, at a level-1 grid, B=1."""
    r = np.random.RandomState(60)
    x, (ta, ba), (tb, bb) = _grid(r, 1, 1, 4), *_sets(r, 4, 6, 2, torch.float32)
    with mock.patch.object(jpk, "_up_fwd_kernel", wraps=jpk._up_fwd_kernel) as spy:
        ya, yb, sa, sb = jpk.fused_up_dual_conv(*_j(x, ta, ba, tb, bb), "average",
                                                with_stats=True)
    assert spy.called
    got = _rows_fwd(pk.up_operand_plain(x), 1, 2, 4, [(ta, ba), (tb, bb)], "average",
                    torch.float32, True)
    _close_tree(got, ([ya, yb], [sa, sb]), 1e-5)


def test_rows_fwd_matches_pallas_pair_interpret(interpret):
    """The formulation on the joined pair against ``fused_up_dual_conv_pair``
    with stats (``_up_pair_fwd_kernel``) in interpret mode, at a level-2
    grid, B=1, corner mode "zeros"."""
    r = np.random.RandomState(61)
    b0, y10, aff = _pair(r, 1, 2, 3, torch.float32)
    (ta, ba), (tb, bb) = _sets(r, 3, 4, 2, torch.float32)
    with mock.patch.object(jpk, "_up_pair_fwd_kernel", wraps=jpk._up_pair_fwd_kernel) as spy:
        ya, yb, sa, sb = jpk.fused_up_dual_conv_pair(_j(*b0), _j(*y10), _j(*aff),
                                                     *_j(ta, ba, tb, bb), "zeros",
                                                     with_stats=True)
    assert spy.called
    rows = pk.up_pair_operand_plain(b0, y10, aff, "zeros")
    got = _rows_fwd(rows, 1, 4, 8, [(ta, ba), (tb, bb)], "zeros", torch.float32, True)
    _close_tree(got, ([ya, yb], [sa, sb]), 1e-5)


# the forward's rows and columns at the model's sites (s=5: B=36 training,
# B=16 serving; the up conv at up0-2 and the VAE's up0, n at up1-2) and at
# the card tests' widths
@pytest.mark.parametrize("rows, ntot, want", [
    (36 * 4 * 160, 512, (4, 180)), (36 * 4 * 640, 256, (2, 720)),
    (36 * 4 * 2560, 128, (1, 2880)), (16 * 4 * 160, 512, (4, 80)),
    (2 * 4 * 10, 40, (1, 1)), (2 * 4 * 640, 9, (1, 40)), (129, 129, (2, 2)), (1, 1, (1, 1))])
def test_mma_fwd_grid(rows, ntot, want):
    """A block a 128 x 128 tile: the grid covers every row and column once,
    and the stats partials have one row a row tile."""
    cols, row_tiles = build.mma_fwd_grid(rows, ntot)
    assert (cols, row_tiles) == want
    assert (cols - 1) * build.MMA_TILE < ntot <= cols * build.MMA_TILE
    assert (row_tiles - 1) * build.MMA_TILE < rows <= row_tiles * build.MMA_TILE


@pytest.mark.parametrize("cin, ntot, want", [(256, 512, (7 * 256, 512)), (128, 128, (896, 128)),
                                             (512, 512, (3584, 512)), (12, 40, (224, 128)),
                                             (20, 9, (224, 128)), (33, 129, (448, 256))])
def test_packed_taps_shape(cin, ntot, want):
    """7 taps of C_in rounded up to the 32-channel K step, the columns to the
    128-column tile: every copy of a tap tile lies inside the buffer."""
    shape = build.packed_taps_shape(cin, ntot)
    assert shape == want
    assert shape[0] % (7 * build.MMA_K_STEP) == 0 and shape[1] % build.MMA_TILE == 0
    assert shape[0] // 7 >= build.operand_width(cin)
