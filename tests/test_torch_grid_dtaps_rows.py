"""The bf16 tensor-core dtaps of the grid convs (the phase conv's, b, and the
standard conv's, f), as their GEMM formulates them, on the CPU: the
act-applied operand (``grid_operand_plain``), the operand's rows gathered
through the conv table times the cotangent rows, and the work split
(``build.grid_dtaps_split``, the NARROW tile of a narrow C_in).

``grid_operand_plain`` is held bit for bit against the JAX package, in
float32 and in bfloat16: the act prologue ``conv_kernel._act_apply`` on each
source, then per sample the sources' cells in order and two poles, for b
``ops/phase.py:_poles`` of the 4 phases, for f the pole cells of
``ops/pad.py:ico_pad`` of the one grid; a zero row after the last sample.

``_rows_dtaps`` replays in plain PyTorch what ``csrc/mma_dtaps.cuh``
computes for b and f: dtaps[t] = sum over rows q of U[row_t(q)]ᵀ·g_eff[q],
the rows q = (sample, output phase slot, cell) over n_out slots from
out_phase0, ``row_t`` read from ``halo.phase_conv_table`` (or
``halo.std_conv_table``): a cell of the sample's n_src·5hw operand cells,
NORTH / SOUTH its two pole rows after them, ZERO the zero row; g_eff the
cotangent with the stats fold, rounded to the dtype; f's sum rounded to the
dtype. ``_narrow_rows_dtaps`` replays the NARROW tile's index maps (a block of
several taps, tile row (tap - t0)·ldk + k, each row gathering those taps'
operand rows). They are held
against the wrappers' plain versions (``phase_conv_dtaps_plain``,
``ico_conv_s2s_dtaps_plain``: autograd of the plain conv) at s=1-4, both
corner modes, with and without act, fold and Σg_eff, both phase-conv modes,
in float32 (1e-5·max|ref|: only the order of the float32 sums differs) and
bfloat16 (2e-2·max|ref|: the float32 sums round to bf16 at different
points), and against the JAX ``_phase_conv_dtaps`` and ``_pallas_dtaps`` in
Pallas interpret mode at one tiny shape (float32, 1e-5). Inputs come from
numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops import phase as jphase
from geniconet_tpu.ops.pad import ico_pad
from geniconet_tpu.ops.pallas import conv_kernel as jck
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu_torch.ops.kernels import build, halo
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

MODES = ["average", "zeros"]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (n_src, n_sets, out_phases) of the phase conv at stride 1 and 2, and the
# standard conv (one source, one table)
KINDS = {"b s1": (4, 1, (0, 1, 2, 3)), "b s2": (4, 2, (2,)), "f": (1, 1, (0,))}


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


class _Case:
    """Seeded numpy inputs at level s, B=2: sources, cotangents, act."""

    def __init__(self, seed, s, cin, cout):
        self.r = np.random.RandomState(seed)
        self.h, self.w, self.cin, self.cout = 2**s, 2 ** (s + 1), cin, cout

    def arr(self, *shape, scale=1.0):
        return (scale * self.r.randn(*shape)).astype(np.float32)

    def grid(self, c):
        return self.arr(2, 5, self.h, self.w, c)

    def act(self):
        return (self.r.uniform(0.5, 1.5, self.cin).astype(np.float32),
                self.arr(self.cin, scale=0.3))


def _t(a, dt=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dt)


def _jax_operand(sources, act, corner_mode, jdt):
    """The operand's rows from the JAX package: (B·(n_src·5hw + 2) + 1, C)
    float32, before the channel padding."""
    xs = [jnp.asarray(x, jdt) for x in sources]
    if act is not None:
        xs = [jck._act_apply(x, *map(jnp.asarray, act)) for x in xs]
    B, _, h, w, C = xs[0].shape
    if len(xs) == 4:
        pn, ps = jphase._poles(tuple(xs), corner_mode)
        poles = jnp.stack([pn[:, 0, 0, 0], ps[:, 0, 0, 0]], axis=1)
    else:
        P = ico_pad(xs[0], h.bit_length() - 1, corner_mode)
        poles = jnp.stack([P[:, 0, 0, 1], P[:, 0, h, w + 1]], axis=1)
    cells = jnp.stack(xs, axis=1).reshape(B, -1, C)
    rows = jnp.concatenate([cells, poles.astype(cells.dtype)], axis=1).reshape(-1, C)
    rows = jnp.concatenate([rows, jnp.zeros((1, C), rows.dtype)])
    return np.asarray(rows.astype(jnp.float32))


@pytest.mark.parametrize("with_act", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("n_src, s, cin", [(4, 2, 12), (4, 3, 16), (1, 2, 5), (1, 4, 16)])
def test_grid_operand_matches_jax(n_src, s, cin, corner_mode, dtype, with_act):
    tdt, jdt = DTYPES[dtype]
    c = _Case(s * 10 + cin, s, cin, 1)
    sources = [c.grid(cin) for _ in range(n_src)]
    act = c.act() if with_act else None
    got = pk.grid_operand([_t(x, tdt) for x in sources], None if act is None else
                          tuple(_t(a) for a in act), corner_mode)
    ref = _jax_operand(sources, act, corner_mode, jdt)
    h, w = c.h, c.w
    assert got.dtype == tdt
    assert got.shape == (pk.grid_operand_rows(2, h, w, n_src), build.operand_width(cin))
    assert not got[:, cin:].float().any()
    np.testing.assert_array_equal(got[:, :cin].float().numpy(), ref)


def _codes(kind, h, w, corner_mode):
    """(slots, 7, M) conv-table codes of the GEMM's output phase slots."""
    n_src, _, out_phases = KINDS[kind]
    if n_src == 1:
        return torch.from_numpy(halo.std_conv_table(h, w, corner_mode)).long()[None]
    table = torch.from_numpy(halo.phase_conv_table(h, w, corner_mode)).long()
    return table[list(out_phases)]


def _gathered(rows, kind, B, h, w, corner_mode):
    """U[row_t(q)]: the operand rows each (sample, slot, tap, cell) reads,
    (B, slots, 7, M, width) in float32 (float64 for a float64 operand)."""
    n_src = KINDS[kind][0]
    M = 5 * h * w
    per = n_src * M + 2
    code = _codes(kind, h, w, corner_mode)
    base = (torch.arange(B) * per).view(B, 1, 1, 1)
    idx = torch.where(code >= 0, base + code,
                      torch.where(code == halo.ZERO, torch.tensor(B * per),
                                  base + per - 2 + (code == halo.SOUTH).long()))
    return rows[idx].to(torch.promote_types(rows.dtype, torch.float32))


def _g_rows(g_groups, y_groups, gs_list):
    """g_eff per set as (B, slots, M, C_out) in float32 (float64 for float64
    cotangents), folded and rounded as the kernel's loads fold it."""
    folded = pk._fold_groups(g_groups, y_groups, gs_list)
    B, cout = folded[0][0].shape[0], folded[0][0].shape[-1]
    return [torch.stack(grp, dim=1).reshape(B, len(grp), -1, cout)
            .to(torch.promote_types(grp[0].dtype, torch.float32)) for grp in folded]


def _rows_dtaps(rows, kind, B, h, w, cin, corner_mode, g_groups, y_groups=None,
                gs_list=None):
    """The GEMM's formulation: per set the float32 (7, C_in, C_out) dtaps and
    the Σg_eff (C_out,)."""
    U = _gathered(rows, kind, B, h, w, corner_mode)
    gsets = _g_rows(g_groups, y_groups, gs_list)
    dtaps = [torch.einsum("bstmk,bsmn->tkn", U, G) for G in gsets]
    return [d[:, :cin] for d in dtaps], [G.sum(dim=(0, 1, 2)) for G in gsets]


def _narrow_rows_dtaps(rows, kind, B, h, w, corner_mode, g_groups, y_groups=None, gs_list=None):
    """The NARROW tile's formulation: block x holds taps t0 = tpb·x .. +tpb-1
    (tpb = ``build.mma_taps_per_block``); the A tile row j·8 + e of a load
    row q is channel 8·(j % cpt) + e of tap t0 + j // cpt's operand row (cpt
    = ldk / 8 chunks a tap; zeros past the block's taps and the 7th), one
    GEMM a block, then tile row (tap - t0)·ldk + k goes to dtaps[tap][k]."""
    ldk = rows.shape[1]
    cpt, tpb = ldk // 8, build.mma_taps_per_block(ldk)
    U = _gathered(rows, kind, B, h, w, corner_mode)  # (B, slots, 7, M, ldk)
    out = [torch.zeros(7, ldk, g_groups[0][0].shape[-1], dtype=U.dtype) for _ in g_groups]
    for t0 in range(0, 7, tpb):
        A = torch.zeros(*U.shape[:2], U.shape[3], build.MMA_TILE, dtype=U.dtype)
        for j in range(build.MMA_TILE // 8):
            tl, sub = divmod(j, cpt)
            if tl < tpb and t0 + tl < 7:
                A[..., 8 * j : 8 * j + 8] = U[:, :, t0 + tl, :, 8 * sub : 8 * sub + 8]
        for o, G in zip(out, _g_rows(g_groups, y_groups, gs_list)):
            tile = torch.einsum("bsmk,bsmn->kn", A, G.to(A.dtype))
            for tl in range(min(tpb, 7 - t0)):
                o[t0 + tl] = tile[tl * ldk : (tl + 1) * ldk]
    return out


def _inputs(kind, s, cin, cout, dt, with_act, fold, seed):
    """Sources, cotangents (set-major groups of the output phases), fold
    arguments and act, from numpy seeds, in dt."""
    n_src, n_sets, out_phases = KINDS[kind]
    c = _Case(seed, s, cin, cout)
    sources = [_t(c.grid(cin), dt) for _ in range(n_src)]
    g = [[_t(c.grid(cout), dt) for _ in out_phases] for _ in range(n_sets)]
    y = [[_t(c.grid(cout), dt) for _ in out_phases] for _ in range(n_sets)] if fold else None
    gs = [_t(c.arr(2, cout, scale=0.1)) for _ in range(n_sets)] if fold else None
    act = tuple(_t(a) for a in c.act()) if with_act else None
    return sources, g, y, gs, act


def _plain(kind, sources, g, y, gs, act, corner_mode, emit_gsum):
    """The wrapper's plain version: b's float32 dtaps per set (and Σg_eff),
    or f's dtaps in the dtype."""
    if kind == "f":
        fk = dict(y=y[0][0], gs=gs[0]) if y is not None else {}
        return ck.ico_conv_s2s_dtaps_plain(sources[0], g[0][0], corner_mode, act, **fk)
    _, n_sets, out_phases = KINDS[kind]
    cin, cout = sources[0].shape[-1], g[0][0].shape[-1]
    return pk.phase_conv_dtaps_plain(sources, g, [(7, cin, cout)] * n_sets, corner_mode,
                                     out_phases, act, y, gs, emit_gsum)


def _close(got, ref, tol):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_rows_dtaps_is_the_plain_dtaps(s, corner_mode, kind, dtype):
    """``_rows_dtaps`` over ``grid_operand_plain`` against the plain
    versions, with and without act and the fold (b: with and without
    Σg_eff); C_in 5 (a ragged operand row), C_out 6."""
    dt = DTYPES[dtype][0]
    for k, (with_act, fold) in enumerate([(True, True), (False, True), (True, False)]):
        sources, g, y, gs, act = _inputs(kind, s, 5, 6, dt, with_act, fold, 40 * s + k)
        B, _, h, w, cin = sources[0].shape
        rows = pk.grid_operand_plain(sources, act, corner_mode)
        dtaps, gsums = _rows_dtaps(rows, kind, B, h, w, cin, corner_mode, g, y, gs)
        ref = _plain(kind, sources, g, y, gs, act, corner_mode, emit_gsum=fold)
        if kind == "f":
            assert ref.dtype == dt
            _close(dtaps[0].to(dt), ref, TOL[dt])
            continue
        ref_dtaps, ref_gsums = ref if fold else (ref, None)
        for u, v in zip(dtaps, ref_dtaps):
            _close(u, v, TOL[dt])
        for u, v in zip(gsums, ref_gsums or ()):
            _close(u, v, TOL[dt])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("cin", [3, 8, 12, 16, 20, 40, 64])
def test_narrow_tile_is_the_wide_one(kind, cin):
    """The NARROW tile's index maps (``_narrow_rows_dtaps``) give the wide
    formulation's dtaps (float64 sums, so the two agree to rounding) at
    C_in that take it: all 7 taps a block (one chunk a tap up to C_in 8,
    two up to 16), 5 (three chunks a tap), 3 (five) and 2 (eight: up2's
    conv01 and down0's stride-2 conv)."""
    assert build.mma_narrow(cin) and not build.mma_narrow(65)
    sources, g, y, gs, act = _inputs(kind, 2, cin, 6, torch.float32, True, True, cin)
    B, _, h, w, _ = sources[0].shape
    rows = pk.grid_operand_plain(sources, act, "average").double()
    g = [[t.double() for t in grp] for grp in g]
    y = [[t.double() for t in grp] for grp in y]
    wide, _ = _rows_dtaps(rows, kind, B, h, w, cin, "average", g, y, gs)
    narrow = _narrow_rows_dtaps(rows, kind, B, h, w, "average", g, y, gs)
    for u, v in zip(narrow, wide):
        assert torch.allclose(u[:, :cin], v, rtol=1e-12, atol=1e-12)
        assert not u[:, cin:].any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_rows_dtaps_matches_pallas(interpret, kind):
    """``_rows_dtaps`` against the JAX ``_phase_conv_dtaps`` (with Σg_eff) or
    ``_pallas_dtaps`` in interpret mode: float32, act and fold on."""
    s, cin, cout = 1, 3, 4
    sources, g, y, gs, act = _inputs(kind, s, cin, cout, torch.float32, True, True, 7)
    B, _, h, w, _ = sources[0].shape
    rows = pk.grid_operand_plain(sources, act, "average")
    dtaps, gsums = _rows_dtaps(rows, kind, B, h, w, cin, "average", g, y, gs)

    def j(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(j(a) for a in tree)
        return jnp.asarray(tree.numpy())

    if kind == "f":
        ref = jck._pallas_dtaps(j(sources[0]), j(g[0][0]), s, "average", 1, j(act),
                                j(y[0][0]), j(gs[0]))
        _close(dtaps[0], torch.from_numpy(np.array(ref)), 1e-5)
        return
    _, n_sets, out_phases = KINDS[kind]
    ref_dtaps, ref_gsums = jpk._phase_conv_dtaps(j(sources), j(g), [(7, cin, cout)] * n_sets,
                                                 "average", out_phases, j(act), j(y), j(gs),
                                                 emit_gsum=True)
    for u, v in zip(dtaps + gsums, list(ref_dtaps) + list(ref_gsums)):
        _close(u, torch.from_numpy(np.array(v)), 1e-5)


# The grid convs' dtaps calls of one s=5 training step at B=36: (phase or
# grid h, w, C_in, columns n_sets·C_out, output phases), b's then f's
B36 = 36
MODEL_SHAPES = {
    "conv_in": (16, 32, 3, 64, 4),
    "up0 conv01": (4, 8, 256, 256, 4),
    "up1 conv01": (8, 16, 128, 128, 4),
    "up2 conv01": (16, 32, 64, 64, 4),
    "down0 s2": (16, 32, 64, 256, 1),
    "down1 s2": (8, 16, 128, 512, 1),
    "down2 s2": (4, 8, 256, 512, 1),
    "VAE heads": (4, 8, 256, 1024, 1),
    "down0 conv01": (16, 32, 128, 128, 1),
    "down1 conv01": (8, 16, 256, 256, 1),
    "down2 conv01": (4, 8, 256, 256, 1),
}


@pytest.mark.parametrize("site", list(MODEL_SHAPES))
def test_grid_dtaps_split_at_the_model_shapes(site):
    """The work split of the grid convs' tensor-core dtaps at each model
    shape: chunks a multiple of the 32-row K step that cover the rows
    exactly once, at least 512 rows each, the grid within one wave of
    ``MMA_TARGET_BLOCKS`` (or one chunk); the NARROW tile at C_in 3
    (conv_in: all 7 taps in one block, one block a chunk, so its chunks fill
    the wave) and 64 (up2 conv01, down0 s2: 2 taps a block, 4 blocks a
    column tile), the wide one from 128 on. The wrapper's scratch
    (``grid_dtaps_scratch``) holds the chunks' partials and the operand."""
    h, w, cin, ntot, n_out = MODEL_SHAPES[site]
    rows = B36 * n_out * 5 * h * w
    narrow = build.mma_narrow(cin)
    assert narrow == (cin <= 64)
    assert build.mma_taps_per_block(cin) == {3: 7, 64: 2}.get(cin, 1)
    kc, n_chunks = build.grid_dtaps_split(rows, cin, ntot)
    blocks = build.mma_dtaps_blocks(cin, ntot, narrow)
    assert kc % build.MMA_K_STEP == 0 and (n_chunks - 1) * kc < rows <= n_chunks * kc
    assert n_chunks == 1 or (blocks * n_chunks <= build.MMA_TARGET_BLOCKS and kc >= 512)
    if site == "conv_in":
        assert blocks == 1 and n_chunks > 200
    n_src = 1 if site.endswith("conv01") and site.startswith("down") else 4
    got = pk.grid_dtaps_scratch(torch.bfloat16, 2, h, w, cin, ntot, n_src, n_out, "meta")
    kc2, n2, ws, operand = got
    assert (kc2, n2) == build.grid_dtaps_split(2 * n_out * 5 * h * w, cin, ntot)
    assert ws.shape == (n2 * 7 * cin * ntot,) and ws.dtype == torch.float32
    assert operand.shape == (2 * (n_src * 5 * h * w + 2) + 1, build.operand_width(cin))
    assert operand.dtype == torch.bfloat16
    kc3, n3, _, none = pk.grid_dtaps_scratch(torch.float32, 2, h, w, cin, ntot, n_src, n_out,
                                             "meta")
    assert none is None and kc3 % 16 == 0
