"""The upsampled operand of the bf16 tensor-core dtaps (``up_operand_plain``,
``up_pair_operand_plain``) against the JAX package, and the GEMM's work
split (``build.mma_dtaps_split``), on the CPU.

The operand is what the up conv (kernel d) and the decoder chain's pair conv
(kernel n) read: per sample the four level-(s+1) phases of the upsampled
level-s grid, then the phase pad's two poles, then one zero row, channels
padded with zeros to a multiple of 8. The JAX side builds the same from
``ops/upsample.py:ico_upsample_s2s``, ``ops/phase.py:phase_split`` and its
``_poles``; for n the level-s grid is ``_updp``'s join
(``phase_kernel.py:_pair_join`` per phase, then ``phase_merge``), run on
plain arrays as ``tests/test_torch_dec_chain.py`` runs the JAX pair. Inputs
come from numpy seeds. The two sides round at the same places, so the
operands are equal bit for bit, in float32 and in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.ops import phase as jphase
from geniconet_tpu.ops.pallas import phase_kernel as jpk
from geniconet_tpu.ops.upsample import ico_upsample_s2s
from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _grid(r, B, s, c):
    return r.randn(B, 5, 2**s, 2 ** (s + 1), c).astype(np.float32)


def _jax_operand(x, s, corner_mode):
    """The operand's rows from the JAX package: (B·(4·5hw + 2) + 1, C)
    float32, before the channel padding."""
    up = ico_upsample_s2s(x, s, corner_mode)
    phases = jphase.phase_split(up)
    B, C = x.shape[0], x.shape[-1]
    pn, ps = jphase._poles(phases, corner_mode)
    cells = jnp.stack(phases, axis=1).reshape(B, -1, C)
    poles = jnp.stack([pn[:, 0, 0, 0], ps[:, 0, 0, 0]], axis=1)
    rows = jnp.concatenate([cells, poles], axis=1).reshape(-1, C)
    rows = jnp.concatenate([rows, jnp.zeros((1, C), rows.dtype)])
    return np.asarray(rows.astype(jnp.float32))


def _check(got, ref, cin):
    got = got.float().numpy()
    assert got.shape == (ref.shape[0], build.operand_width(cin))
    assert not got[:, cin:].any()
    np.testing.assert_array_equal(got[:, :cin], ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
@pytest.mark.parametrize("s, cin", [(2, 12), (3, 16), (4, 5)])
def test_up_operand_matches_jax_upsample(s, cin, corner_mode, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _grid(np.random.RandomState(s), 2, s, cin)
    got = pk.up_operand_plain(torch.from_numpy(x).to(tdt), corner_mode)
    assert got.dtype == tdt
    _check(got, _jax_operand(jnp.asarray(x).astype(jdt), s, corner_mode), cin)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("corner_mode", ["average", "zeros"])
@pytest.mark.parametrize("s, cin", [(2, 12), (3, 8), (4, 3)])
def test_up_pair_operand_matches_jax_pair_join(s, cin, corner_mode, dtype):
    tdt, jdt = DTYPES[dtype]
    r = np.random.RandomState(10 + s)
    b0 = [_grid(r, 2, s - 1, cin) for _ in range(4)]
    y10 = [_grid(r, 2, s - 1, cin) for _ in range(4)]
    aff = [r.uniform(0.5, 1.5, cin).astype(np.float32), (0.3 * r.randn(cin)).astype(np.float32),
           r.uniform(0.5, 1.5, cin).astype(np.float32), (0.3 * r.randn(cin)).astype(np.float32)]
    got = pk.up_pair_operand_plain([torch.from_numpy(a).to(tdt) for a in b0],
                                   [torch.from_numpy(a).to(tdt) for a in y10],
                                   [torch.from_numpy(a) for a in aff], corner_mode)
    joined = [jpk._pair_join(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                             *map(jnp.asarray, aff), jdt) for a, b in zip(b0, y10)]
    x = jphase.phase_merge(joined)
    _check(got, _jax_operand(x, s, corner_mode), cin)


def test_up_operand_layout():
    """Row p·5hw + chart·hw + i·w + j of sample b is cell (chart, i, j) of
    upsampled phase p; then the north and south pole rows; the zero row
    last."""
    x = torch.from_numpy(_grid(np.random.RandomState(0), 3, 2, 4))
    rows = pk.up_operand_plain(x, "average")
    phases = pk._up_phases(x, "average")
    per = 4 * 5 * 4 * 8 + 2
    assert rows.shape == (3 * per + 1, 8)
    for b in range(3):
        for p in range(4):
            assert torch.equal(rows[b * per + p * 160 + 1 * 32 + 2 * 8 + 5, :4],
                               phases[p][b, 1, 2, 5])
        assert torch.allclose(rows[b * per + 640, :4], phases[0][b, :, 0, 0].mean(0))
        assert torch.allclose(rows[b * per + 641, :4], phases[3][b, :, 3, 7].mean(0))
    assert not rows[-1].any()


# the tensor-core dtaps' rows and blocks a chunk at the model's sites (s=5,
# B=36; d at up0-2 and the VAE's up0, n at up1-2) and at the card tests'
SPLIT_CASES = [(36 * 4 * 160, (256, 512)), (36 * 4 * 640, (256, 256)), (36 * 4 * 2560, (128, 128)),
               (36 * 4 * 160, (512, 512)), (2 * 4 * 10, (12, 40)), (2 * 4 * 640, (12, 40)),
               (2 * 4 * 2560, (12, 20)), (4 * 4 * 640, (16, 32)), (1, (8, 8)),
               (100000, (1024, 4096)), (31, (8, 8)), (33, (8, 8))]


def test_mma_dtaps_blocks():
    """The 7 taps' 128-channel tiles times the 128-column tiles."""
    assert [build.mma_dtaps_blocks(c, n) for c, n in
            [(256, 512), (256, 256), (128, 128), (512, 512), (12, 40)]] == [56, 28, 7, 112, 7]


@pytest.mark.parametrize("rows, shape", SPLIT_CASES)
def test_mma_dtaps_split(rows, shape):
    """Chunks cover the rows exactly, each a multiple of the 32-row K step
    (the last may be short), and the grid stays within the target block
    count unless one chunk's blocks alone exceed it."""
    out_tiles = build.mma_dtaps_blocks(*shape)
    kc, n_chunks = build.mma_dtaps_split(rows, out_tiles)
    assert kc % build.MMA_K_STEP == 0 and kc > 0
    assert (n_chunks - 1) * kc < rows <= n_chunks * kc
    assert n_chunks * out_tiles <= max(build.MMA_TARGET_BLOCKS, out_tiles)


def test_operand_width():
    assert [build.operand_width(c) for c in (1, 8, 12, 16, 20, 128)] == [8, 8, 16, 16, 24, 128]
