"""The CUDA kernels on the card, against their plain PyTorch versions.

This file imports no JAX, so it runs on the card's machine (which has no
JAX) with the JAX-only conftest left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips. Tolerances: float32 1e-4·max|ref|
(only the order of the float32 sums differs), bfloat16 2e-2·max|ref| (the
float32 sums round to bf16 at different points).
"""

import contextlib
import copy

import pytest
import torch

from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
from geniconet_tpu_torch.ops.kernels import build
from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
from geniconet_tpu_torch.ops.phase import phase_merge, phase_split

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODES = ["average", "zeros"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dt):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= TOL[dt] * scale, (err, scale)


def _inputs(device, dt, s, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    h, w = 2**s, 2 ** (s + 1)
    x = torch.randn(2, 5, h, w, cin, generator=g).to(device, dt)
    act = (torch.rand(cin, generator=g).add(0.5).to(device),
           (0.3 * torch.randn(cin, generator=g)).to(device))
    sets = [((torch.randn(7, cin, cout, generator=g) * (7 * cin) ** -0.5).to(device, dt),
             torch.randn(cout, generator=g).to(device, dt)) for _ in range(2)]
    return x, act, sets


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 5])
def test_phase_conv(cuda, s, corner_mode, dt):
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=s)
    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    for out_phases, tap_sets, a in [((0, 1, 2, 3), sets[:1], None), ((2,), sets, act),
                                    ((0, 1, 2, 3), [(sets[0][0], None)], act)]:
        got = pk.phase_conv_fwd(phases, tap_sets, corner_mode, out_phases, a)
        ref = pk.phase_conv_fwd_plain(phases, tap_sets, corner_mode, out_phases, a)
        for outs_g, outs_r in zip(got, ref):
            for u, v in zip(outs_g, outs_r):
                _close(u, v, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [0, 2, 4])
def test_up_dual_conv(cuda, s, corner_mode, dt):
    x, _, sets = _inputs(cuda, dt, s, 12, 20, seed=10 + s)
    for tap_sets in (sets, sets[:1]):
        got = pk.up_dual_conv_fwd(x, tap_sets, corner_mode)
        ref = pk.up_dual_conv_fwd_plain(x, tap_sets, corner_mode)
        for outs_g, outs_r in zip(got, ref):
            for u, v in zip(outs_g, outs_r):
                _close(u, v, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 4])
def test_ico_conv(cuda, s, corner_mode, dt):
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=20 + s)
    for a, bias in [(act, sets[0][1]), (None, None)]:
        _close(ck.ico_conv_s2s_fwd(x, sets[0][0], bias, corner_mode, a),
               ck.ico_conv_s2s_fwd_plain(x, sets[0][0], bias, corner_mode, a), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_pair_head(cuda, dt):
    g = torch.Generator().manual_seed(3)
    b0 = [torch.randn(2, 5, 16, 32, 24, generator=g).to(cuda, dt) for _ in range(8)]
    aff = [t.to(cuda) for t in (torch.rand(24, generator=g) + 0.5, torch.randn(24, generator=g),
                                torch.rand(24, generator=g) + 0.5, torch.randn(24, generator=g))]
    W = (torch.randn(24, 3, generator=g) * 0.2).to(cuda, dt)
    bias = torch.randn(3, generator=g).to(cuda, dt)
    got = pk.pair_head_fwd(b0[:4], b0[4:], aff, W, bias)
    for u, v in zip(got, pk.pair_head_fwd_plain(b0[:4], b0[4:], aff, W, bias)):
        assert u.dtype == torch.float32
        _close(u, v, dt)


def test_wrappers_check_their_inputs(cuda):
    x, act, sets = _inputs(cuda, torch.float32, 3, 8, 8, seed=1)
    strided = x.transpose(-1, -2).contiguous().transpose(-1, -2)  # same shape, not contiguous
    with pytest.raises(ValueError):
        ck.ico_conv_s2s_fwd(strided, *sets[0])
    with pytest.raises(TypeError):  # taps in another dtype
        ck.ico_conv_s2s_fwd(x, sets[0][0].double(), sets[0][1])
    with pytest.raises(ValueError):  # act on the wrong device
        ck.ico_conv_s2s_fwd(x, *sets[0], act=tuple(a.cpu() for a in act))


@pytest.mark.parametrize("dt", DTYPES)
def test_model_kernel_route_matches_plain_route(cuda, dt):
    """IcoAE on the card (kernels) against the same model on the CPU (plain)."""
    s, widths = 4, (16, 24, 32)
    model = IcoAE(s, widths, dtype=dt)
    model.load_state_dict(bridge.flax_to_state_dict(
        bridge.init_variables(s, widths, seed=0, random_stats=True)))
    model.eval()
    x = 0.5 * torch.randn(2, 5 * 2**s, 2 ** (s + 1), 3, generator=torch.Generator().manual_seed(0))
    build.reset_launches()
    with torch.inference_mode():
        got = copy.deepcopy(model).to(cuda).forward(x.to(cuda))
        torch.cuda.synchronize()
        ref = model(x)
    assert set(build.LAUNCHES) == {"phase_conv_fwd", "up_dual_conv_fwd", "ico_conv_s2s_fwd",
                                   "pair_head_fwd"}
    # bf16 rounding differences compound through ten layers: 5e-2·max|ref|
    tol = 1e-4 if dt == torch.float32 else 5e-2
    err = (got.cpu() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


# ---------------------------------------------------------------------------
# training: forward stats and the four backward kernels
# ---------------------------------------------------------------------------


def _stats_fold(device, dt, shape, n_sets, seed):
    """Cotangents of the outputs and of their [sum, sumsq] stats, per set."""
    g = torch.Generator().manual_seed(seed)

    def mk(n):
        return [[torch.randn(*shape, generator=g).to(device, dt) for _ in range(n)]
                for _ in range(n_sets)]

    return mk, [torch.randn(2, shape[-1], generator=g).mul(1e-3).to(device)
                for _ in range(n_sets)]


def _close_all(got, ref, dt):
    for u, v in zip(got, ref):
        if isinstance(v, (tuple, list)):
            _close_all(u, v, dt)
        elif v is None:
            assert u is None
        else:
            _close(u, v, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 5])
def test_forward_stats(cuda, s, corner_mode, dt):
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=30 + s)
    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    for out_phases, n in [((0, 1, 2, 3), 1), ((2,), 2)]:
        got = pk.phase_conv_fwd(phases, sets[:n], corner_mode, out_phases, act, with_stats=True)
        ref = pk.phase_conv_fwd_plain(phases, sets[:n], corner_mode, out_phases, act, True)
        _close_all(got, ref, dt)
    if s < 5:
        got = pk.up_dual_conv_fwd(x, sets, corner_mode, with_stats=True)
        _close_all(got, pk.up_dual_conv_fwd_plain(x, sets, corner_mode, True), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 5])
def test_phase_conv_backward(cuda, s, corner_mode, dt):
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=40 + s)
    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    mk, gs = _stats_fold(cuda, dt, phases[0].shape[:-1] + (20,), 2, seed=s)
    for out_phases, n, a, fold in [((0, 1, 2, 3), 1, act, True), ((2,), 2, act, True),
                                   ((0, 1, 2, 3), 1, None, False), ((2,), 2, None, True)]:
        g = [grp[: len(out_phases)] for grp in mk(len(out_phases))][:n]
        y = [grp[: len(out_phases)] for grp in mk(len(out_phases))][:n] if fold else None
        fk = dict(y_groups=y, gs_list=gs[:n]) if fold else {}
        args = (g, sets[:n], corner_mode, out_phases, 12, dt, a, phases if a else None)
        _close_all(pk.phase_conv_dx(*args, **fk), pk.phase_conv_dx_plain(*args, **fk), dt)
        shapes = [(7, 12, 20)] * n
        args = (phases, g, shapes, corner_mode, out_phases, a)
        _close_all(pk.phase_conv_dtaps(*args, **fk, emit_gsum=True),
                   pk.phase_conv_dtaps_plain(*args, **fk, emit_gsum=True), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [0, 2, 4])
def test_up_dual_conv_backward(cuda, s, corner_mode, dt):
    x, _, sets = _inputs(cuda, dt, s, 12, 20, seed=50 + s)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (20,), 2, seed=s)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        args = (g, sets, corner_mode, dt)
        _close_all(pk.up_dual_conv_dx(*args, **fk, emit_gsum=True),
                   pk.up_dual_conv_dx_plain(*args, **fk, emit_gsum=True), dt)
        _close_all(pk.up_dual_conv_dtaps(x, g, corner_mode, **fk),
                   pk.up_dual_conv_dtaps_plain(x, g, corner_mode, **fk), dt)


# ---------------------------------------------------------------------------
# the default training route: the standard conv's stats, dx and dtaps, and
# the head+MSE forward and backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 4])
def test_ico_conv_stats_and_backward(cuda, s, corner_mode, dt):
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=60 + s)
    taps, bias = sets[0]
    _close_all(ck.ico_conv_s2s_fwd(x, taps, bias, corner_mode, act, with_stats=True),
               ck.ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode, act, with_stats=True), dt)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (20,), 1, seed=s)
    for a, fold, emit in [(act, True, True), (None, False, True), (act, False, False)]:
        g, y = mk(1)[0][0], mk(1)[0][0]
        fk = dict(y=y, gs=gs[0]) if fold else {}
        args = (g, taps, corner_mode, dt, a, x if a else None)
        _close_all(ck.ico_conv_s2s_dx(*args, **fk, emit_gsum=emit),
                   ck.ico_conv_s2s_dx_plain(*args, **fk, emit_gsum=emit), dt)
        got = ck.ico_conv_s2s_dtaps(x, g, corner_mode, a, **fk)
        assert got.dtype == dt
        _close(got, ck.ico_conv_s2s_dtaps_plain(x, g, corner_mode, a, **fk), dt)


def _head_mse_inputs(device, dt, s, C, seed, B=3):
    g = torch.Generator().manual_seed(seed)
    h, w = 2**s, 2 ** (s + 1)
    b0 = [torch.randn(B, 5, h, w, C, generator=g).to(device, dt) for _ in range(8)]
    aff = [t.to(device) for t in (torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g),
                                  torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g))]
    W = (torch.randn(C, 3, generator=g) * C**-0.5).to(device, dt)
    bias = (0.1 * torch.randn(3, generator=g)).to(device, dt)
    tpack = torch.rand(B, 5, h, w, 12, generator=g).mul(2).sub(1).to(device)
    tpoles = torch.rand(B, 6, generator=g).mul(2).sub(1).to(device)
    return b0[:4], b0[4:], aff, W, bias, tpack, tpoles


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s, C", [(1, 24), (3, 64), (4, 64)])
def test_pair_head_mse(cuda, s, C, dt):
    args = _head_mse_inputs(cuda, dt, s, C, seed=70 + s)
    got = pk.pair_head_mse_fwd(*args)
    assert got.dtype == torch.float32 and got.shape == (3,)
    _close(got, pk.pair_head_mse_fwd_plain(*args), dt)
    g = torch.tensor([1.0, 0.5, -2.0], device=cuda)
    got = pk.pair_head_mse_bwd(g, *args)
    ref = pk.pair_head_mse_bwd_plain(g, *args)
    for u, v in zip(got[:2], ref[:2]):
        for a, b in zip(u, v):
            assert a.dtype == dt
            _close(a, b, dt)
    for a, b in zip(got[2:], ref[2:]):
        assert a.dtype == torch.float32
        _close(a, b, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s, C", [(1, 24), (3, 64), (4, 64)])
def test_pair_head_bwd(cuda, s, C, dt):
    """Kernel e against its plain version: the 8 phase cotangents, dW and
    dbias (in W's dtype) and the 4 affine gradients."""
    b0, y10, aff, W, bias, _, _ = _head_mse_inputs(cuda, dt, s, C, seed=80 + s)
    gen = torch.Generator().manual_seed(90 + s)
    g = tuple(torch.randn(b0[0].shape[:-1] + (3,), generator=gen).to(cuda) for _ in range(4))
    got = pk.pair_head_bwd(g, b0, y10, aff, W, bias)
    ref = pk.pair_head_bwd_plain(g, b0, y10, aff, W, bias)
    for u, v in zip(got[:2], ref[:2]):
        for a, b in zip(u, v):
            assert a.dtype == dt
            _close(a, b, dt)
    for a, b in zip(got[2:], ref[2:]):
        assert a.dtype == b.dtype
        _close(a, b, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B", [2, 36])
@pytest.mark.parametrize("kernel", ["e", "h"])
def test_head_bwd_at_the_model_shapes(cuda, kernel, B, dt):
    """The pair head's backward at the s=5 head (C 64, F 3, the level-4
    phases (16, 32)), B=2 and 36: kernel e (``pair_head_bwd``, given g) and
    h (``pair_head_mse_bwd``, g from the target) against their plain
    versions within TOL (the 8 phase cotangents, dW, dbias, the affine
    gradients), and a second call equal to the first bit for bit (a fixed
    grid and fixed-order merges, no atomics)."""
    b0, y10, aff, W, bias, tpack, tpoles = _head_mse_inputs(cuda, dt, 4, 64, seed=B, B=B)
    gen = torch.Generator().manual_seed(B + 1)
    if kernel == "e":
        g = tuple(torch.randn(B, 5, 16, 32, 3, generator=gen).to(cuda) for _ in range(4))
        args = (g, b0, y10, aff, W, bias)
        call, plain, name = pk.pair_head_bwd, pk.pair_head_bwd_plain, "pair_head_bwd"
    else:
        g = torch.randn(B, generator=gen).to(cuda)
        args = (g, b0, y10, aff, W, bias, tpack, tpoles)
        call, plain, name = pk.pair_head_mse_bwd, pk.pair_head_mse_bwd_plain, "pair_head_mse_bwd"
    build.reset_launches()
    got = call(*args)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 1}
    ref = plain(*args)
    for u, v in zip(got[:2], ref[:2]):
        for x, y in zip(u, v):
            assert x.dtype == dt
            _close(x, y, dt)
    for x, y in zip(got[2:], ref[2:]):
        assert x.dtype == y.dtype
        _close(x, y, dt)
    _equal_all(call(*args), got)


@pytest.mark.parametrize("C, F, dt", [(12, 1, torch.bfloat16), (24, 5, torch.bfloat16),
                                      (20, 8, torch.float32), (160, 3, torch.float32),
                                      (256, 8, torch.float32), (256, 3, torch.bfloat16)])
def test_head_bwd_ragged_widths(cuda, C, F, dt):
    """e and h at widths the model has not, against their plain versions
    within TOL: C 12 in bf16 (not a multiple of 8: channel by channel, not
    16 bytes a lane), F 5 and 8 (W's 8 columns held), float32 C 160 and
    256 (two 16-byte chunks a lane), C 256 in bf16 (32 lanes a cell); B=3
    at level 2."""
    _check_head_bwds(cuda, C, F, dt)


def _check_head_bwds(cuda, C, F, dt, seed=None):
    """e and h at (C, F), B=3 at level 2, against their plain versions
    within TOL, and each a second time equal to the first bit for bit."""
    gen = torch.Generator().manual_seed(C + F if seed is None else seed)
    B, h, w = 3, 4, 8

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen)

    b0 = [rnd(B, 5, h, w, C).to(cuda, dt) for _ in range(4)]
    y10 = [rnd(B, 5, h, w, C).to(cuda, dt) for _ in range(4)]
    aff = [t.to(cuda) for t in (rnd(C).abs() + 0.5, rnd(C), rnd(C).abs() + 0.5, rnd(C))]
    W, bias = rnd(C, F, scale=C**-0.5).to(cuda, dt), rnd(F, scale=0.1).to(cuda, dt)
    tpack = rnd(B, 5, h, w, 4 * F).clamp(-1, 1).to(cuda)
    tpoles = rnd(B, 2 * F).clamp(-1, 1).to(cuda)
    g = tuple(rnd(B, 5, h, w, F).to(cuda) for _ in range(4))
    gb = rnd(B).to(cuda)
    for call, plain, args in (
            (pk.pair_head_bwd, pk.pair_head_bwd_plain, (g, b0, y10, aff, W, bias)),
            (pk.pair_head_mse_bwd, pk.pair_head_mse_bwd_plain,
             (gb, b0, y10, aff, W, bias, tpack, tpoles))):
        got, ref = call(*args), plain(*args)
        for u, v in zip(got[:2], ref[:2]):
            for x, y in zip(u, v):
                _close(x, y, dt)
        for x, y in zip(got[2:], ref[2:]):
            assert x.dtype == y.dtype
            _close(x, y, dt)
        _equal_all(call(*args), got)


def _head_fwd_inputs(cuda, dt, B, C, F, seed, h=16, w=32, offset=0):
    """The head's inputs at level (h, w); ``offset``: every phase starts that
    many elements into its own buffer (not 16-byte aligned for offset 1)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen)

    def phase():
        n = B * 5 * h * w * C
        return rnd(n + offset).to(cuda, dt)[offset:].view(B, 5, h, w, C)

    b0, y10 = [phase() for _ in range(4)], [phase() for _ in range(4)]
    aff = [t.to(cuda) for t in (rnd(C).abs() + 0.5, rnd(C), rnd(C).abs() + 0.5, rnd(C))]
    W, bias = rnd(C, F, scale=C**-0.5).to(cuda, dt), rnd(F, scale=0.1).to(cuda, dt)
    tpack = rnd(B, 5, h, w, 4 * F).clamp(-1, 1).to(cuda)
    tpoles = rnd(B, 2 * F).clamp(-1, 1).to(cuda)
    return b0, y10, aff, W, bias, tpack, tpoles


def _check_head_fwds(args, dt):
    """Both forwards against their plain versions within TOL, each one
    launch; the MSE forward's sse twice, bit for bit (a fixed order). The
    forward's outputs are first given memory that holds NaN (blocks of their
    size freed just before, which the caching allocator hands out again),
    so a float the kernel leaves unwritten shows."""
    x0, F = args[0][0], args[3].shape[-1]
    nan = [torch.full((*x0.shape[:-1], F), float("nan"), device=x0.device) for _ in range(4)]
    del nan
    build.reset_launches()
    got = pk.pair_head_fwd(*args[:5])
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"pair_head_fwd": 1}
    for u, v in zip(got, pk.pair_head_fwd_plain(*args[:5])):
        assert u.dtype == torch.float32
        _close(u, v, dt)
    sse = pk.pair_head_mse_fwd(*args)
    assert sse.dtype == torch.float32 and sse.shape == (args[0][0].shape[0],)
    _close(sse, pk.pair_head_mse_fwd_plain(*args), dt)
    assert torch.equal(pk.pair_head_mse_fwd(*args), sse)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B", [1, 16, 36])
def test_head_fwd_at_the_model_shapes(cuda, B, dt):
    """The head's forward (``pair_head_fwd``) and the head+MSE forward (g,
    ``pair_head_mse_fwd``) at the s=5 head (C 64, F 3, the level-4 phases
    (16, 32)): B=1 (a decode: a group a cell and phase), 16 (serving) and
    36 (training), against their plain versions within TOL."""
    _check_head_fwds(_head_fwd_inputs(cuda, dt, B, 64, 3, seed=100 + B), dt)


@pytest.mark.parametrize("C, F, dt", [(24, 1, torch.bfloat16), (60, 3, torch.bfloat16),
                                      (200, 8, torch.bfloat16), (24, 8, torch.float32),
                                      (62, 1, torch.float32), (200, 3, torch.float32),
                                      (320, 3, torch.bfloat16), (600, 8, torch.float32),
                                      (2000, 1, torch.float32), (8, 3, torch.bfloat16),
                                      (8, 3, torch.float32), (4, 8, torch.float32),
                                      (16, 8, torch.bfloat16)])
def test_head_fwd_ragged_widths(cuda, C, F, dt):
    """Both forwards at widths the model has not, B=3 at level 2, against
    their plain versions within TOL: C 60 (bf16) and 62 (float32), not a
    multiple of the 16-byte chunk (channel by channel); F 1 and 8 (W's 8
    columns held); C 200 (32 lanes a cell; in float32 two rounds of
    chunks); C 320 (bf16) and 600 (float32), several rounds, and C 2000, F
    1, whose shared memory (56 KB) needs the opt-in above 48 KB; groups
    narrower than F, where a lane writes several of v's floats: C 8 (bf16:
    1 lane, float32: 2) with F 3, C 4 (float32) and 16 (bf16) with F 8."""
    args = _head_fwd_inputs(cuda, dt, 3, C, F, seed=C + F, h=4, w=8)
    _check_head_fwds(args, dt)


@pytest.mark.parametrize("C, F, dt", [(320, 3, torch.bfloat16), (600, 3, torch.float32),
                                      (768, 3, torch.bfloat16), (1000, 8, torch.float32)])
def test_head_training_kernels_at_wide_heads(cuda, C, F, dt):
    """The head's training kernels at heads wider than 256 channels, where
    the backward walks a cell in rounds (``head_bwd_wide_body``): g (with
    the head's forward) and e and h against their plain versions within
    TOL, B=3 at level 2: C 320 (bf16) and 600 (float32); C 768 (bf16) and
    1000 with F 8 (float32), whose backward's shared memory (55 KB, 92 KB)
    needs the opt-in above 48 KB."""
    _check_head_fwds(_head_fwd_inputs(cuda, dt, 3, C, F, seed=C + F + 1, h=4, w=8), dt)
    _check_head_bwds(cuda, C, F, dt, seed=C + F + 2)


def test_head_mse_forms_the_heads_v_at_c320(cuda):
    """g forms each cell's v with the bits of ``pair_head_fwd`` at C 320
    (bf16, 32 lanes a cell, two rounds of chunks): against the forward's
    own v as the target, every squared error is 0 and so is each sample's
    sse, exactly (a v one bf16 rounding of z apart would add its square).
    The pole cells' joins are all below 0 and the bias is 0, so each pole's
    v, mean and target are 0 and the pole term is 0 whatever order and
    contraction its arithmetic takes."""
    b0, y10, aff, W, bias, _, _ = _head_fwd_inputs(cuda, torch.bfloat16, 3, 320, 3, seed=321,
                                                   h=4, w=8)
    bias = torch.zeros_like(bias)
    for x in (b0[0], y10[0]):
        x[:, :, 0, 0] = -1e4
    for x in (b0[3], y10[3]):
        x[:, :, -1, -1] = -1e4
    v = pk.pair_head_fwd(b0, y10, aff, W, bias)
    assert not any(t[:, :, i, i].any() for t, i in ((v[0], 0), (v[3], -1)))
    tpack = torch.cat(v, dim=-1).contiguous()
    tpoles = torch.zeros((3, 6), device=cuda)
    sse = pk.pair_head_mse_fwd(b0, y10, aff, W, bias, tpack, tpoles)
    assert torch.equal(sse, torch.zeros_like(sse)), sse


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
def test_head_fwd_unaligned_phases(cuda, B, dt):
    """Phases that do not start on 16 bytes take the channel-by-channel
    loads: both forwards within TOL at the model's head shape, and equal
    bit for bit to the same values read 16 bytes at a time."""
    args = _head_fwd_inputs(cuda, dt, B, 64, 3, seed=110 + B, offset=1)
    assert args[0][0].data_ptr() % 16 != 0
    _check_head_fwds(args, dt)
    aligned = ([t.clone() for t in args[0]], [t.clone() for t in args[1]], *args[2:])
    assert aligned[0][0].data_ptr() % 16 == 0
    _equal_all(pk.pair_head_fwd(*aligned[:5]), pk.pair_head_fwd(*args[:5]))
    assert torch.equal(pk.pair_head_mse_fwd(*aligned), pk.pair_head_mse_fwd(*args))


@pytest.mark.parametrize("dt", DTYPES)
def test_head_kernels_share_one_cell_order(cuda, dt):
    """The head forms v in one order: sample 0's v from a B=16 call (a group
    a cell, 4 phases) equals a B=1 call's (a group a cell and phase) bit
    for bit, and the MSE forward's sse equals the squared error of the
    forward's own v (poles included), summed in float64, within float32
    summation noise (1e-5·sse)."""
    b0, y10, aff, W, bias, tpack, tpoles = _head_fwd_inputs(cuda, dt, 16, 64, 3, seed=120)
    full = pk.pair_head_fwd(b0, y10, aff, W, bias)
    one = pk.pair_head_fwd([t[:1] for t in b0], [t[:1] for t in y10], aff, W, bias)
    _equal_all(one, tuple(v[:1] for v in full))
    v = [t.double() for t in full]
    sse = sum(((vp - tpack[..., p * 3:(p + 1) * 3].double()) ** 2).sum(dim=(1, 2, 3, 4))
              for p, vp in enumerate(v))
    pn = sum(v[0][:, c, 0, 0] for c in range(5)) * 0.2
    ps = sum(v[3][:, c, -1, -1] for c in range(5)) * 0.2
    sse = (sse + ((pn - tpoles[:, :3].double()) ** 2).sum(1)
           + ((ps - tpoles[:, 3:].double()) ** 2).sum(1))
    got = pk.pair_head_mse_fwd(b0, y10, aff, W, bias, tpack, tpoles).double()
    assert ((got - sse).abs() <= 1e-5 * sse).all(), (got - sse).abs().max().item()


def test_vae_default_training_route_launches_every_vae_training_kernel(cuda):
    """One training forward and backward of the default VAE (every block and
    the heads on the kernels, eps fixed) under a linear loss of (recon, mu,
    logvar) with random weights: every kernel of the VAE's path launches,
    the head's backward included, and the gradients match the CPU's."""
    s, widths, latent = 4, (8, 16, 16), 8
    model = IcoVAE(s, widths, latent)
    model.load_state_dict(bridge.flax_to_state_dict(bridge.init_variables(
        s, widths, seed=1, random_stats=True, model="ico2ico_vae", latent_features=latent)))
    gen = torch.Generator().manual_seed(3)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    eps = torch.randn(4, 5 * 2 ** (s - 3), 2 ** (s - 2), latent, generator=gen)
    cts = [torch.randn(x.shape, generator=gen), torch.randn(eps.shape, generator=gen),
           torch.randn(eps.shape, generator=gen)]

    def loss_of(m, dev):
        from unittest import mock

        import geniconet_tpu_torch.nn.models as models

        def fixed(mu, logvar, generator=None):
            return eps.to(dev) * torch.exp(0.5 * logvar) + mu

        with mock.patch.object(models, "reparameterize", fixed):
            outs = m(x.to(dev), train=True)
        return sum((o * c.to(dev)).sum() for o, c in zip(outs, cts))

    card = copy.deepcopy(model).to(cuda)
    build.reset_launches()
    loss = loss_of(card, cuda)
    loss.backward()
    torch.cuda.synchronize()
    assert set(build.LAUNCHES) == {
        "phase_conv_fwd", "up_dual_conv_fwd", "ico_conv_s2s_fwd", "pair_head_fwd",
        "phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx", "up_dual_conv_dtaps",
        "ico_conv_s2s_dx", "ico_conv_s2s_dtaps", "pair_head_bwd"}
    ref = loss_of(model, "cpu")
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    for (k, p), q in zip(card.named_parameters(), model.parameters()):
        scale = q.grad.abs().max().item()
        if "conv" in k and k.endswith(".bias"):  # feeds a BatchNorm: exact gradient 0
            scale = dict(model.named_parameters())[k[: -len("bias")] + "taps"].grad.abs().max()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-3 * float(scale), k


def test_default_training_route_launches_every_training_kernel(cuda):
    """One training step of the default routing on the card: every kernel
    but the serving head launches, and the loss and gradients match the
    same model on the CPU."""
    s, widths = 3, (8, 16, 16)
    model = IcoAE(s, widths)
    model.load_state_dict(bridge.flax_to_state_dict(
        bridge.init_variables(s, widths, seed=1, random_stats=True)))
    gen = torch.Generator().manual_seed(2)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    tpack = torch.randn(4, 5, 2 ** (s - 1), 2**s, 12, generator=gen)
    tpoles = torch.randn(4, 6, generator=gen)
    card = copy.deepcopy(model).to(cuda)
    build.reset_launches()
    loss = card.recon_sse(x.to(cuda), tpack.to(cuda), tpoles.to(cuda), train=True).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert set(build.LAUNCHES) == {
        "phase_conv_fwd", "up_dual_conv_fwd", "ico_conv_s2s_fwd", "phase_conv_dx",
        "phase_conv_dtaps", "up_dual_conv_dx", "up_dual_conv_dtaps", "ico_conv_s2s_dx",
        "ico_conv_s2s_dtaps", "pair_head_mse_fwd", "pair_head_mse_bwd"}
    ref = model.recon_sse(x, tpack, tpoles, train=True).sum()
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    for (k, p), q in zip(card.named_parameters(), model.parameters()):
        scale = q.grad.abs().max().item()
        # a conv's bias feeds a BatchNorm: its exact gradient is 0
        if ".conv" in k and k.endswith(".bias"):
            scale = dict(model.named_parameters())[k[: -len("bias")] + "taps"].grad.abs().max()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-3 * float(scale), k


# ---------------------------------------------------------------------------
# the merged one-pass backward: kernels i, j and k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 4])
def test_phase_conv_bwd(cuda, s, corner_mode, dt):
    """Kernel i against its plain version: both output-phase modes, 1 and 2
    sets, with and without the act prologue and the stats fold."""
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=100 + s)
    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    mk, gs = _stats_fold(cuda, dt, phases[0].shape[:-1] + (20,), 2, seed=s)
    for out_phases, n, a, fold in [((0, 1, 2, 3), 1, act, True), ((2,), 2, act, True),
                                   ((0, 1, 2, 3), 1, None, False), ((2,), 2, None, True)]:
        g = mk(len(out_phases))[:n]
        y = mk(len(out_phases))[:n] if fold else None
        args = (phases, g, y, gs[:n] if fold else None, sets[:n], corner_mode, out_phases, a,
                fold, dt)
        got = pk.phase_conv_bwd(*args)
        assert [d.dtype for d in got[1] + got[2]] == [torch.float32] * (2 * n)
        _close_all(got, pk.phase_conv_bwd_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [0, 3])
def test_up_dual_conv_bwd(cuda, s, corner_mode, dt):
    """Kernel j against its plain version, with and without the fold."""
    x, _, sets = _inputs(cuda, dt, s, 12, 20, seed=110 + s)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (20,), 2, seed=s)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        _close_all(pk.up_dual_conv_bwd(x, g, sets, corner_mode, **fk),
                   pk.up_dual_conv_bwd_plain(x, g, sets, corner_mode, **fk), dt)


# (level s, C_in, C_out) of j's bit-for-bit cases: levels 0 and 3 at narrow
# widths, and a VAE-up0-like C_in of 512 (the latent) at level 2
UP_BWD_CASES = {"s0": (0, 12, 20), "s3": (3, 12, 20), "VAE up0": (2, 512, 256)}


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", list(UP_BWD_CASES))
def test_up_dual_conv_bwd_is_the_split_pair(cuda, case, corner_mode):
    """Kernel j in bf16 is the split route's device code over one folded
    cotangent: c's cotangent pass, dx GEMM, upsample adjoint and Σg_eff
    pass, and d's dtaps GEMM on d's split over the written rows, whose
    values are d's in-kernel fold (both round ``fold_geff`` once). So its
    five outputs equal ``up_dual_conv_dx`` + ``up_dual_conv_dtaps`` bit for
    bit, with the fold and without, in one launch of the wrapper."""
    s, cin, cout = UP_BWD_CASES[case]
    dt = torch.bfloat16
    x, _, sets = _inputs(cuda, dt, s, cin, cout, seed=140 + s)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (cout,), 2, seed=s)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        build.reset_launches()
        got = pk.up_dual_conv_bwd(x, g, sets, corner_mode, **fk)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"up_dual_conv_bwd": 1}
        dx, gsums = pk.up_dual_conv_dx(g, sets, corner_mode, dt, **fk, emit_gsum=True)
        _equal_all(got, (dx, *pk.up_dual_conv_dtaps(x, g, corner_mode, **fk), *gsums))
        _close_all(got, pk.up_dual_conv_bwd_plain(x, g, sets, corner_mode, **fk), dt)


# (level s, C_in, C_out) of k's bit-for-bit cases: levels 2 and 4 at a
# NARROW C_in (level 2 is a (4, 8) grid: 160 rows a sample, no tap mask, row
# tiles straddling samples), and a down2-conv01-like C_in of 256 at level 2
STD_BWD_CASES = {"s2": (2, 12, 20), "s4": (4, 12, 20), "down2 conv01": (2, 256, 256)}


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", list(STD_BWD_CASES))
def test_ico_conv_bwd_is_the_split_pair(cuda, case, corner_mode):
    """Kernel k in bf16 is f's split route over one folded cotangent: f's
    cotangent pass, f's operand pass, one launch of f's dtaps and dx GEMMs
    (the dtaps over the written rows, whose values are f's in-kernel fold:
    both round ``fold_geff`` once), then f's sums. So dx, the bf16 dtaps,
    Σg_eff, d_mul and d_add equal ``ico_conv_s2s_dx(emit_gsum=True)`` +
    ``ico_conv_s2s_dtaps`` bit for bit, with the act and the fold on and
    off, in one launch of the wrapper."""
    s, cin, cout = STD_BWD_CASES[case]
    dt = torch.bfloat16
    x, act, sets = _inputs(cuda, dt, s, cin, cout, seed=160 + s)
    taps = sets[0][0]
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (cout,), 1, seed=s)
    for a, fold in [(act, True), (None, False), (act, False), (None, True)]:
        g = mk(1)[0][0]
        y, g_s = (mk(1)[0][0], gs[0]) if fold else (None, None)
        build.reset_launches()
        got = ck.ico_conv_s2s_bwd(x, g, taps, y, g_s, corner_mode, a, fold, dt)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"ico_conv_s2s_bwd": 1}
        assert got[1].dtype == dt
        dx, dmul, dadd, gsum = ck.ico_conv_s2s_dx(g, taps, corner_mode, dt, a, x, y, g_s, True)
        _equal_all(got, (dx, ck.ico_conv_s2s_dtaps(x, g, corner_mode, a, y, g_s), gsum, dmul,
                         dadd))
        _close_all(got, ck.ico_conv_s2s_bwd_plain(x, g, taps, y, g_s, corner_mode, a, fold, dt),
                   dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 4])
def test_ico_conv_bwd(cuda, s, corner_mode, dt):
    """Kernel k against its plain version: act and fold on and off; dtaps
    in the activation dtype."""
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=120 + s)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (20,), 1, seed=s)
    for a, fold in [(act, True), (None, False), (act, False), (None, True)]:
        g, y = mk(1)[0][0], mk(1)[0][0]
        args = (x, g, sets[0][0], y if fold else None, gs[0] if fold else None, corner_mode, a,
                fold, dt)
        got = ck.ico_conv_s2s_bwd(*args)
        assert got[1].dtype == dt
        _close_all(got, ck.ico_conv_s2s_bwd_plain(*args), dt)


def test_merged_wrappers_check_their_inputs(cuda):
    x, act, sets = _inputs(cuda, torch.float32, 2, 8, 8, seed=2)
    phases = tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))
    g = [[torch.zeros_like(phases[0]) for _ in range(4)]]
    with pytest.raises(TypeError):  # out_dtype is not the activations'
        pk.phase_conv_bwd(phases, g, None, None, sets[:1], "average", (0, 1, 2, 3), act, False,
                          torch.bfloat16)
    with pytest.raises(ValueError):  # one tap set: the up conv takes two
        pk.up_dual_conv_bwd(x, [[torch.zeros_like(x)] * 4], sets[:1], "average")
    with pytest.raises(ValueError):  # g on the CPU
        ck.ico_conv_s2s_bwd(x, x.cpu(), sets[0][0])


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_merged_training_route_launches_the_merged_kernels(cuda, model):
    """One training forward and backward with ``merged_bwd="all"`` on the
    card: kernels i, j and k launch, the split dx kernels and the split
    up-conv and standard-conv dtaps do not (``conv_in`` keeps its
    ``phase_conv_dtaps``). The merged kernels run the split kernels' dx and
    dtaps tiles on the same work split, so every gradient equals the split
    route's on the card bit for bit, but for the conv biases (Σg_eff summed
    in another order; each feeds a BatchNorm, so its exact gradient is 0 and
    it is held against its taps' scale); the loss matches the CPU's."""
    s, widths, latent = 4, (8, 16, 16), 8
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(s, widths, seed=1, random_stats=True, model=model,
                                      latent_features=latent)
    gen = torch.Generator().manual_seed(4)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    eps = torch.randn(4, 5 * 2 ** (s - 3), 2 ** (s - 2), latent, generator=gen)
    tpack = torch.randn(4, 5, 2 ** (s - 1), 2**s, 12, generator=gen)
    tpoles = torch.randn(4, 6, generator=gen)
    cts = [torch.randn(x.shape, generator=gen), torch.randn(eps.shape, generator=gen),
           torch.randn(eps.shape, generator=gen)]

    def run(route, dev):
        from unittest import mock

        import geniconet_tpu_torch.nn.models as models

        net = (IcoVAE(s, widths, latent, merged_bwd=route) if vae
               else IcoAE(s, widths, merged_bwd=route))
        net.load_state_dict(bridge.flax_to_state_dict(variables))
        net.to(dev)
        build.reset_launches()
        if vae:
            def fixed(mu, logvar, generator=None):
                return eps.to(dev) * torch.exp(0.5 * logvar) + mu

            with mock.patch.object(models, "reparameterize", fixed):
                outs = net(x.to(dev), train=True)
            loss = sum((o * c.to(dev)).sum() for o, c in zip(outs, cts))
        else:
            loss = net.recon_sse(x.to(dev), tpack.to(dev), tpoles.to(dev), train=True).sum()
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        return loss.item(), dict(build.LAUNCHES), {k: p.grad.cpu() for k, p in
                                                   net.named_parameters()}

    loss, launches, grads = run("all", cuda)
    head = ("pair_head_fwd", "pair_head_bwd") if vae else ("pair_head_mse_fwd",
                                                           "pair_head_mse_bwd")
    assert set(launches) == {
        "phase_conv_fwd", "up_dual_conv_fwd", "ico_conv_s2s_fwd", "phase_conv_bwd",
        "up_dual_conv_bwd", "ico_conv_s2s_bwd", "phase_conv_dtaps", *head}
    assert launches["phase_conv_dtaps"] == 1  # conv_in, which has no dx
    split_loss, _, split = run(None, cuda)
    assert loss == split_loss
    for k, g in grads.items():
        if "conv" in k and k.endswith(".bias"):
            err = (g - split[k]).abs().max().item()
            assert err <= 1e-5 * split[k[: -len("bias")] + "taps"].abs().max().item(), k
        else:
            assert torch.equal(g, split[k]), k
    ref_loss, _, _ = run("all", "cpu")
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)


# ---------------------------------------------------------------------------
# the encoder's phase chain (kernel m) and the stats fold outside the
# kernels (kernel l)
# ---------------------------------------------------------------------------


def _split(x):
    return tuple(x[:, :, p >> 1 :: 2, p & 1 :: 2].contiguous() for p in range(4))


def _merge(groups):
    return [(phase_merge(tuple(g)).contiguous(),) for g in groups]


def _within_ulp(got, ref):
    """Each bf16 tensor within one bf16 ulp of its max|ref|, plus 1e-5·max|ref|
    of float32 noise: what float32 sums taken in two orders, each rounded to
    bf16 (or summed from such roundings), can differ by."""
    for u, v in zip(_flat_all(got), _flat_all(ref)):
        err, scale = (u.float() - v.float()).abs().max().item(), v.float().abs().max().item()
        assert u.dtype == v.dtype and err <= (2**-7 + 1e-5) * scale, (err, scale)


def _equal_all(got, ref):
    for u, v in zip(got, ref):
        if isinstance(v, (tuple, list)):
            _equal_all(u, v)
        elif v is None:
            assert u is None
        else:
            assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [2, 4])
def test_ds2s_is_the_phase_conv_split(cuda, s, corner_mode, dt):
    """Kernel m against the phase conv's kernels with output phase 2: its
    split is addressing only (the same GEMM, row order and loads), so the
    outputs and stats equal ``phase_conv_fwd`` + ``phase_split``, and dx,
    d_mul/d_add, dtaps and Σg_eff equal ``phase_conv_dx`` /
    ``phase_conv_dtaps`` on the ``phase_merge``d cotangents, bit for bit in
    both dtypes; and m is within the tolerance of its plain versions. In
    bf16 m's forward is the phase conv's tensor-core forward at output
    phase 2 (its operand pass, tap pack and GEMM) with the split store in
    the GEMM's epilogue, each row to its parity phase (at s=2 a 128-row tile
    spans both samples); its stats are taken of the same rounded values in
    the same row-tile order. With the act and without, 1 and 2 tap sets,
    with stats and without. m's bf16 dx is a's cotangent pass (its rows read
    from the phases), tensor-core GEMM, epilogue and Σg_eff pass, and m's
    bf16 dtaps is b's operand pass and tensor-core GEMM with its cotangent
    rows read from the phases (the same values, split and sums)."""
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=130 + s)
    phases = _split(x)
    for a, n, with_stats in ((act, 2, True), (None, 2, True), (act, 1, True), (None, 1, False)):
        got = pk.ds2s_fwd(phases, sets[:n], corner_mode, a, with_stats)
        ref = pk.phase_conv_fwd(phases, sets[:n], corner_mode, (2,), a, with_stats)
        ref_sets = ref[0] if with_stats else ref
        split = [_split(y) for (y,) in ref_sets]
        _equal_all(got, (split, ref[1]) if with_stats else split)
        _close_all(got, pk.ds2s_fwd_plain(phases, sets[:n], corner_mode, a, with_stats), dt)
    mk, gs = _stats_fold(cuda, dt, phases[0].shape[:2] + (2 ** (s - 2), 2 ** (s - 1), 20), 2,
                         seed=s)
    shapes = [(7, 12, 20)] * 2
    for a, fold in [(act, True), (None, True), (act, False), (None, False)]:
        g = mk(4)
        y = mk(4) if fold else None
        fk = dict(y_groups=y, gs_list=gs) if fold else {}
        fkm = dict(y_groups=_merge(y), gs_list=gs) if fold else {}
        raw = phases if a else None
        got = pk.ds2s_dx(g, sets, corner_mode, 12, dt, a, raw, **fk)
        ref = pk.phase_conv_dx(_merge(g), sets, corner_mode, (2,), 12, dt, a, raw, **fkm)
        _equal_all(got, ref)  # bf16: a's pass and GEMM, its cotangent rows from the phases
        _close_all(got, pk.ds2s_dx_plain(g, sets, corner_mode, 12, dt, a, raw, **fk), dt)
        got = pk.ds2s_dtaps(phases, g, shapes, corner_mode, a, **fk, emit_gsum=True)
        ref = pk.phase_conv_dtaps(phases, _merge(g), shapes, corner_mode, (2,), a, **fkm,
                                  emit_gsum=True)
        _equal_all(got, ref)  # bf16: b's pass and GEMM, its G rows from the phases
        _close_all(got, pk.ds2s_dtaps_plain(phases, g, shapes, corner_mode, a, **fk,
                                            emit_gsum=True), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n, C", [(4, 64), (2, 128), (1, 20)])
def test_stats_geff(cuda, n, C, dt):
    """Kernel l against its plain version: the same float32 operations in
    the same order, rounded once, so equal (C=20 takes the scalar loads)."""
    gen = torch.Generator().manual_seed(140 + C + n)
    shape = (3, 5, 4, 8, C)
    g = [torch.randn(shape, generator=gen).to(cuda, dt) for _ in range(n)]
    y = [torch.randn(shape, generator=gen).to(cuda, dt) for _ in range(n)]
    gs = torch.randn(2, C, generator=gen).to(cuda)
    _equal_all(pk.stats_geff(g, y, gs), pk.geff_plain(g, y, gs))


def _fold_placement(cuda, model, chain, outside):
    """One training forward and backward of the s=4 model on ``chain``, with
    every family folding in-kernel (``kernel_geff=None``) and with
    ``outside`` (kernel l folds the families it leaves out before their
    kernels). l rounds g_eff as the kernels' own fold does, so every
    gradient is equal bit for bit, but for the conv biases (Σg_eff from
    another kernel; each feeds a BatchNorm, so its exact gradient is 0 and
    it is held against its taps' scale); the loss matches the CPU's.
    Returns the kernels the in-kernel run launched."""
    s, widths, latent = 4, (8, 16, 16), 8
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(s, widths, seed=2, random_stats=True, model=model,
                                      latent_features=latent)
    gen = torch.Generator().manual_seed(5)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    eps = torch.randn(4, 5 * 2 ** (s - 3), 2 ** (s - 2), latent, generator=gen)
    tpack = torch.randn(4, 5, 2 ** (s - 1), 2**s, 12, generator=gen)
    tpoles = torch.randn(4, 6, generator=gen)
    cts = [torch.randn(x.shape, generator=gen), torch.randn(eps.shape, generator=gen),
           torch.randn(eps.shape, generator=gen)]

    def run(kernel_geff, dev):
        from unittest import mock

        import geniconet_tpu_torch.nn.models as models

        kw = dict(phase_chain=chain, kernel_geff=kernel_geff)
        net = IcoVAE(s, widths, latent, **kw) if vae else IcoAE(s, widths, **kw)
        net.load_state_dict(bridge.flax_to_state_dict(variables))
        net.to(dev)
        build.reset_launches()
        if vae:
            def fixed(mu, logvar, generator=None):
                return eps.to(dev) * torch.exp(0.5 * logvar) + mu

            with mock.patch.object(models, "reparameterize", fixed):
                outs = net(x.to(dev), train=True)
            loss = sum((o * c.to(dev)).sum() for o, c in zip(outs, cts))
        else:
            loss = net.recon_sse(x.to(dev), tpack.to(dev), tpoles.to(dev), train=True).sum()
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        return loss.item(), dict(build.LAUNCHES), {k: p.grad.cpu() for k, p in
                                                   net.named_parameters()}

    loss, launches, grads = run(None, cuda)
    out_loss, out_launches, out = run(outside, cuda)
    assert set(out_launches) == set(launches) | {"stats_geff"}
    assert out_loss == loss
    for k, g in out.items():
        if "conv" in k and k.endswith(".bias"):
            err = (g - grads[k]).abs().max().item()
            assert err <= 1e-6 * grads[k[: -len("bias")] + "taps"].abs().max().item(), k
        else:
            assert torch.equal(g, grads[k]), k
    ref_loss, _, _ = run(None, "cpu")
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    return launches


def _head(vae):
    return ("pair_head_fwd", "pair_head_bwd") if vae else ("pair_head_mse_fwd",
                                                           "pair_head_mse_bwd")


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_fold_outside_the_kernels_equals_the_fold_inside(cuda, model):
    """The encoder's phase chain with JAX's built-in fold set (``""``)
    against the fold in-kernel (``_fold_placement``); the chain launches
    kernel m and no standard conv."""
    launches = _fold_placement(cuda, model, "enc", "")
    assert set(launches) == {"phase_conv_fwd", "ds2s_fwd", "up_dual_conv_fwd", "ds2s_dx",
                             "ds2s_dtaps", "phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx",
                             "up_dual_conv_dtaps", *_head(model == "ico2ico_vae")}


# ---------------------------------------------------------------------------
# the decoder's phase chain (kernel n)
# ---------------------------------------------------------------------------


def _pair(device, dt, s, cin, seed):
    """The raw phase pair (4 + 4 phases) of a level-s grid and its 4 affines."""
    g = torch.Generator().manual_seed(seed)
    hp = 2 ** (s - 1)
    ph = [torch.randn(2, 5, hp, 2 * hp, cin, generator=g).to(device, dt) for _ in range(8)]
    aff = [t.to(device) for t in (torch.rand(cin, generator=g) + 0.5,
                                  0.3 * torch.randn(cin, generator=g),
                                  torch.rand(cin, generator=g) + 0.5,
                                  0.3 * torch.randn(cin, generator=g))]
    return ph[:4], ph[4:], aff


def _join_adjoint(dx, b0, y10, aff):
    """The residual join's adjoint on a float32 level-s dx, as the reference
    writes it: the 8 phase cotangents and the 4 affine gradients."""
    mul1, add1, mul2, add2 = aff
    db0, dy10, dm1, da, dm2 = [], [], 0.0, 0.0, 0.0
    for d, a, b in zip(phase_split(dx.float()), b0, y10):
        a32, b32 = a.float(), b.float()
        dpre = d * (a32 * mul1 + add1 + b32 * mul2 + add2 > 0.0).float()
        db0.append((dpre * mul1).to(a.dtype))
        dy10.append((dpre * mul2).to(a.dtype))
        dm1 = dm1 + (dpre * a32).sum(dim=(0, 1, 2, 3))
        da = da + dpre.sum(dim=(0, 1, 2, 3))
        dm2 = dm2 + (dpre * b32).sum(dim=(0, 1, 2, 3))
    return tuple(db0), tuple(dy10), dm1, da, dm2, da


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 4])
def test_up_pair_is_the_up_conv_on_the_joined_grid(cuda, s, corner_mode, dt):
    """Kernel n against the up conv's kernels on ``phase_merge`` of the
    joined pair: the join on load rounds as the plain join does and the
    GEMM, its row order and its loads are the up conv's, so the outputs,
    stats and dtaps are equal bit for bit; dx (float32) is within 1e-5 of
    ``up_dual_conv_dx`` followed by the join's adjoint, its Σg_eff equal;
    and every output is within the tolerance of the plain versions."""
    b0, y10, aff = _pair(cuda, dt, s, 12, seed=150 + s)
    _, _, sets = _inputs(cuda, dt, s, 12, 20, seed=160 + s)
    x = phase_merge(tuple(pk.pair_join(a, b, aff) for a, b in zip(b0, y10))).contiguous()
    assert x.shape[2:4] == (2**s, 2 ** (s + 1))
    _equal_all(pk.up_pair_fwd(b0, y10, aff, sets, corner_mode),
               pk.up_dual_conv_fwd(x, sets, corner_mode))
    got = pk.up_pair_fwd(b0, y10, aff, sets, corner_mode, with_stats=True)
    _equal_all(got, pk.up_dual_conv_fwd(x, sets, corner_mode, with_stats=True))
    _close_all(got, pk.up_pair_fwd_plain(b0, y10, aff, sets, corner_mode, True), dt)
    mk, gs = _stats_fold(cuda, dt, x.shape[:-1] + (20,), 2, seed=170 + s)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        got = pk.up_pair_dtaps(b0, y10, aff, g, corner_mode, **fk)
        _equal_all(got, pk.up_dual_conv_dtaps(x, g, corner_mode, **fk))
        _close_all(got, pk.up_pair_dtaps_plain(b0, y10, aff, g, corner_mode, **fk), dt)
        got = pk.up_pair_dx(g, b0, y10, aff, sets, corner_mode, emit_gsum=True, **fk)
        _close_all(got, pk.up_pair_dx_plain(g, b0, y10, aff, sets, corner_mode, emit_gsum=True,
                                            **fk), dt)
        if dt == torch.float32:
            dx, gsums = pk.up_dual_conv_dx(g, sets, corner_mode, dt, emit_gsum=True, **fk)
            for u, v in zip(_flat_all(got[:6]), _flat_all(_join_adjoint(dx, b0, y10, aff))):
                assert (u - v).abs().max().item() <= 1e-5 * v.abs().max().item()
            _equal_all(got[6], gsums)


def _flat_all(out):
    return [out] if isinstance(out, torch.Tensor) else [x for o in out for x in _flat_all(o)]


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [1, 3, 4])
def test_up_pair_dx_is_the_up_conv_dx(cuda, s, corner_mode):
    """Kernel n's bf16 dx is c's route (cotangent pass, tensor-core GEMM into
    dU) with the pair tail in its adjoint pass, which sums each level-s
    cell's dx as c's pass does: the float32 dx it masks is c's unrounded dx
    bit for bit. With mul1 = 1, mul2 = 0 and add1 + add2 = 64, so that every
    mask is on, db0 = bf16(dx) is ``phase_split`` of ``up_dual_conv_dx`` on
    the same cotangents, bit for bit, every dy10 is 0 and Σg_eff is c's;
    with the fold and without, one launch of the wrapper, two calls
    bit-equal, every output within TOL of the plain version."""
    dt = torch.bfloat16
    b0, y10, _ = _pair(cuda, dt, s, 12, seed=180 + s)
    one, zero = torch.ones(12, device=cuda), torch.zeros(12, device=cuda)
    aff = [one, torch.full((12,), 64.0, device=cuda), zero, zero]
    _, _, sets = _inputs(cuda, dt, s, 12, 20, seed=190 + s)
    mk, gs = _stats_fold(cuda, dt, (2, 5, 2**s, 2 ** (s + 1), 20), 2, seed=200 + s)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        build.reset_launches()
        got = pk.up_pair_dx(g, b0, y10, aff, sets, corner_mode, emit_gsum=True, **fk)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"up_pair_dx": 1}
        dx, gsums = pk.up_dual_conv_dx(g, sets, corner_mode, dt, emit_gsum=True, **fk)
        _equal_all(got[0], phase_split(dx))
        assert all(t.dtype == dt and not bool(t.float().abs().max()) for t in got[1])
        _equal_all(got[6], gsums)
        _equal_all(got, pk.up_pair_dx(g, b0, y10, aff, sets, corner_mode, emit_gsum=True, **fk))
        _close_all(got, pk.up_pair_dx_plain(g, b0, y10, aff, sets, corner_mode, emit_gsum=True,
                                            **fk), dt)


@pytest.mark.parametrize("route", ["chain all", "dec"])
@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_pair_dx(cuda, model, route):
    """A bf16 training step on the decoder's chain (``phase_chain`` "1" and
    "dec": n's dx at up1 and up2). In the step, every call of n's dx is
    within TOL of its plain version on that call's own inputs; a trace of
    the step shows n's tensor-core dx GEMM (``mma_conv<PairCells, DuEpi>``)
    and its pair adjoint pass once a call, and no bf16 ``dx_gemm``."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    routing = dict(phase_chain="1" if route == "chain all" else "dec")
    calls = []

    def checked(*args, **kwargs):
        got = pk.up_pair_dx(*args, **kwargs)
        calls.append((got, pk.up_pair_dx_plain(*args, **kwargs)))
        return got

    with mock.patch.object(fused, "up_pair_dx", checked):
        _, launches, grads = _bf16_step(cuda, model, **routing)
    n = launches.get("up_pair_dx", 0)
    assert n == 2 and len(calls) == n
    for got, ref in calls:
        _close_all(got, ref, torch.bfloat16)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    names = _dx_kernel_names(lambda: _bf16_step(cuda, model, **routing))
    count = {k: sum(c for name, c in names.items() if all(p in name for p in k))
             for k in (("mma_conv", "DuEpi", "PairCells"), ("pair_adjoint_pass",),
                       ("dx_gemm", "bfloat16"))}
    assert count[("mma_conv", "DuEpi", "PairCells")] == n, count
    assert count[("pair_adjoint_pass",)] == n, count
    assert count[("dx_gemm", "bfloat16")] == 0, count


def test_up_pair_wrappers_check_their_inputs(cuda):
    b0, y10, aff = _pair(cuda, torch.float32, 2, 8, seed=3)
    _, _, sets = _inputs(cuda, torch.float32, 2, 8, 8, seed=4)
    with pytest.raises(ValueError):  # a phase of another shape
        pk.up_pair_fwd(b0, (*y10[:3], y10[3][:, :, :1].contiguous()), aff, sets)
    with pytest.raises(TypeError):  # affines in the activation dtype's place
        pk.up_pair_fwd(b0, y10, [a.double() for a in aff], sets)
    with pytest.raises(ValueError):  # one tap set
        pk.up_pair_fwd(b0, y10, aff, sets[:1])


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_chain_all_fold_outside_equals_the_fold_inside(cuda, model):
    """Both halves chained (``phase_chain="1"``) with every stats fold
    outside the kernels (``kernel_geff="0"``) against the fold in-kernel
    (``_fold_placement``): the chain launches m and n, no standard conv,
    and n's forward, dx and dtaps at up1 and up2."""
    launches = _fold_placement(cuda, model, "1", "0")
    assert set(launches) == {"phase_conv_fwd", "ds2s_fwd", "up_dual_conv_fwd", "up_pair_fwd",
                             "ds2s_dx", "ds2s_dtaps", "phase_conv_dx", "phase_conv_dtaps",
                             "up_dual_conv_dx", "up_dual_conv_dtaps", "up_pair_dx",
                             "up_pair_dtaps", *_head(model == "ico2ico_vae")}
    assert launches["up_pair_fwd"] == launches["up_pair_dx"] == 2
    assert launches["up_dual_conv_fwd"] == 1


# ---------------------------------------------------------------------------
# the merged blocks (kernels o and p)
# ---------------------------------------------------------------------------


def _block_params(device, dt, cin, c0, c2, seed):
    """Three tap sets (conv00, conv10: cin -> c0; conv01: c0 -> c2) and
    bn00's float32 gamma, beta."""
    g = torch.Generator().manual_seed(seed)
    sets = [((torch.randn(7, a, b, generator=g) * (7 * a) ** -0.5).to(device, dt),
             torch.randn(b, generator=g).to(device, dt)) for a, b in ((cin, c0), (cin, c0),
                                                                      (c0, c2))]
    gamma = (torch.rand(c0, generator=g) + 0.5).to(device)
    beta = (0.3 * torch.randn(c0, generator=g)).to(device)
    return sets, gamma, beta


def _check_affine(mul, add, s00, count, gamma, beta):
    """The kernel's affine against ``bn_affine_plain`` on the card (as
    ``IcoBatchNorm.affine`` computes it): mul within 1 ulp (the kernel's
    rsqrtf against PyTorch's rsqrt), add exactly the formula on that mul."""
    ref_mul, _ = pk.bn_affine_plain(s00, count, gamma, beta)
    ulp = torch.nextafter(ref_mul.abs(), torch.tensor(float("inf"), device=ref_mul.device))
    assert bool(((mul - ref_mul).abs() <= ulp - ref_mul.abs()).all())
    assert torch.equal(add, beta - s00[0] / count * mul)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [3, 4])
def test_up_block_is_the_split_pair(cuda, s, corner_mode, dt):
    """Kernel o against the split route on the card: y00, y10, s00 and s10
    equal ``up_dual_conv_fwd`` with stats; mul00 and add00 are bn00's affine
    of s00 (``_check_affine``); b0 and s01 equal ``phase_conv_fwd`` of y00
    with that affine; each bit for bit in both dtypes (float32: both the
    SIMT tile; bf16: both the tensor-core passes, the same operand, packed
    taps, tiles, partials and reduction order); and every output is within
    the tolerance of ``up_block_fwd_plain``. C_in 12 takes the operand
    pass's channel-by-channel loads; 16 its 8-channel loads."""
    for cin in (12, 16):
        x, _, _ = _inputs(cuda, dt, s, cin, 20, seed=180 + s + cin)
        sets, gamma, beta = _block_params(cuda, dt, cin, 20, 24, seed=190 + s + cin)
        got = pk.up_block_fwd(x, sets, gamma, beta, corner_mode)
        b0, y10, y00, s00, s01, s10, mul, add = got
        ref_sets, ref_stats = pk.up_dual_conv_fwd(x, sets[:2], corner_mode, True)
        _equal_all((y00, y10, s00, s10), (*ref_sets, *ref_stats))
        _check_affine(mul, add, s00, 4.0 * y00[0].shape[:-1].numel(), gamma, beta)
        (ref_b0,), (ref_s01,) = pk.phase_conv_fwd(y00, sets[2:], corner_mode, (0, 1, 2, 3),
                                                  (mul, add), True)
        _equal_all((b0, s01), (ref_b0, ref_s01))
        _close_all(got, pk.up_block_fwd_plain(x, sets, gamma, beta, corner_mode), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [3, 4])
def test_dn_block_is_the_split_pair(cuda, s, corner_mode, dt):
    """Kernel p against the split route on the card, with and without the
    pending act: y00, y10, s00 and s10 equal ``phase_conv_fwd`` with output
    phase 2 and stats; mul00 and add00 are bn00's affine of s00; b0 and s01
    equal ``ico_conv_s2s_fwd`` of y00 with that affine; each bit for bit in
    both dtypes (float32: both the SIMT tile; bf16: both the tensor-core
    passes); and every output is within the tolerance of
    ``dn_block_fwd_plain``. C_in 12 and 16, as for o."""
    for cin in (12, 16):
        x, act, _ = _inputs(cuda, dt, s, cin, 20, seed=200 + s + cin)
        phases = _split(x)
        sets, gamma, beta = _block_params(cuda, dt, cin, 20, 24, seed=210 + s + cin)
        for a in (act, None):
            got = pk.dn_block_fwd(phases, sets, gamma, beta, a, corner_mode)
            b0, y10, y00, s00, s01, s10, mul, add = got
            ((ref00,), (ref10,)), ref_stats = pk.phase_conv_fwd(phases, sets[:2], corner_mode,
                                                                (2,), a, True)
            _equal_all((y00, y10, s00, s10), (ref00, ref10, *ref_stats))
            _check_affine(mul, add, s00, float(y00.shape[:-1].numel()), gamma, beta)
            _equal_all((b0, s01),
                       ck.ico_conv_s2s_fwd(y00, *sets[2], corner_mode, (mul, add), True))
            _close_all(got, pk.dn_block_fwd_plain(phases, sets, gamma, beta, a, corner_mode),
                       dt)


def test_block_wrappers_check_their_inputs(cuda):
    x, _, _ = _inputs(cuda, torch.float32, 2, 8, 8, seed=5)
    sets, gamma, beta = _block_params(cuda, torch.float32, 8, 8, 8, seed=6)
    with pytest.raises(ValueError):  # two tap sets: the block takes three
        pk.up_block_fwd(x, sets[:2], gamma, beta)
    with pytest.raises(TypeError):  # gamma in the activation dtype's place
        pk.up_block_fwd(x, sets, gamma.double(), beta)
    with pytest.raises(ValueError):  # conv01 not from c0
        pk.dn_block_fwd(_split(x), [*sets[:2], (sets[2][0][:, :4].contiguous(), sets[2][1])],
                        gamma, beta)
    with pytest.raises(ValueError):  # a phase on the CPU
        pk.dn_block_fwd((*_split(x)[:3], _split(x)[3].cpu()), sets, gamma, beta)


def _block_step(cuda, model, merged_block, dtype=torch.float32, **routing):
    """One s=4 training forward and backward on the card in ``dtype`` with
    ``merged_block`` (and the other routing options): (loss, launches,
    gradients)."""
    from unittest import mock

    import geniconet_tpu_torch.nn.models as models

    s, widths, latent = 4, (8, 16, 16), 8
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(s, widths, seed=3, random_stats=True, model=model,
                                      latent_features=latent)
    gen = torch.Generator().manual_seed(6)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    eps = torch.randn(4, 5 * 2 ** (s - 3), 2 ** (s - 2), latent, generator=gen)
    tpack = torch.randn(4, 5, 2 ** (s - 1), 2**s, 12, generator=gen)
    tpoles = torch.randn(4, 6, generator=gen)
    cts = [torch.randn(x.shape, generator=gen), torch.randn(eps.shape, generator=gen),
           torch.randn(eps.shape, generator=gen)]
    kw = dict(merged_block=merged_block, dtype=dtype, **routing)
    net = IcoVAE(s, widths, latent, **kw) if vae else IcoAE(s, widths, **kw)
    net.load_state_dict(bridge.flax_to_state_dict(variables))
    net.to(cuda)
    build.reset_launches()
    if vae:
        def fixed(mu, logvar, generator=None):
            return eps.to(cuda) * torch.exp(0.5 * logvar) + mu

        with mock.patch.object(models, "reparameterize", fixed):
            outs = net(x.to(cuda), train=True)
        loss = sum((o * c.to(cuda)).sum() for o, c in zip(outs, cts))
    else:
        loss = net.recon_sse(x.to(cuda), tpack.to(cuda), tpoles.to(cuda), train=True).sum()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), dict(build.LAUNCHES), {k: p.grad.cpu() for k, p in net.named_parameters()}


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_merged_block_step_equals_the_split_route(cuda, model):
    """One training forward and backward with ``merged_block="all"``: o at
    every UpBlock and p at every DownBlock (the split forward kernels only
    at ``conv_in`` and the VAE's heads), and the gradients equal the split
    route's on the card bit for bit, but for the conv biases (each feeds a
    BatchNorm, so its exact gradient is 0; held against its taps' scale):
    the kernels' outputs and sums equal the split pair's and the backward
    is the split route's. With ``phase_chain="1"`` o runs at up0 alone."""
    vae = model == "ico2ico_vae"
    loss, launches, grads = _block_step(cuda, model, "all")
    assert launches["up_block_fwd"] == 3 and launches["dn_block_fwd"] == (2 if vae else 3)
    assert launches["phase_conv_fwd"] == (2 if vae else 1)
    assert "up_dual_conv_fwd" not in launches and "ico_conv_s2s_fwd" not in launches
    split_loss, _, split = _block_step(cuda, model, None)
    assert loss == split_loss
    for k, g in grads.items():
        if "conv" in k and k.endswith(".bias"):
            err = (g - split[k]).abs().max().item()
            assert err <= 1e-5 * split[k[: -len("bias")] + "taps"].abs().max().item(), k
        else:
            assert torch.equal(g, split[k]), k
    _, chained, _ = _block_step(cuda, model, "all", phase_chain="1")
    assert chained["up_block_fwd"] == 1 and "dn_block_fwd" not in chained


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_merged_block_step_equals_the_split_route_in_bf16(cuda, model):
    """The same step in bf16: o and p run the split route's tensor-core
    passes in one cooperative launch, so the loss equals the split route's
    and every gradient does bit for bit, but for the conv biases (held as in
    float32); with ``phase_chain="1"`` o runs at up0 alone."""
    vae, bf = model == "ico2ico_vae", torch.bfloat16
    loss, launches, grads = _block_step(cuda, model, "all", bf)
    assert launches["up_block_fwd"] == 3 and launches["dn_block_fwd"] == (2 if vae else 3)
    assert "up_dual_conv_fwd" not in launches and "ico_conv_s2s_fwd" not in launches
    split_loss, _, split = _block_step(cuda, model, None, bf)
    assert loss == split_loss
    for k, g in grads.items():
        if "conv" in k and k.endswith(".bias"):
            err = (g - split[k]).abs().max().item()
            assert err <= 1e-5 * split[k[: -len("bias")] + "taps"].abs().max().item(), k
        else:
            assert torch.equal(g, split[k]), k
    _, chained, _ = _block_step(cuda, model, "all", bf, phase_chain="1")
    assert chained["up_block_fwd"] == 1 and "dn_block_fwd" not in chained


# ---------------------------------------------------------------------------
# the bf16 dtaps of the up conv (d) and of the decoder's chain (n) on the
# tensor cores: the operand pass, then the GEMM over its gathered rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin", [12, 16])
@pytest.mark.parametrize("source", ["grid", "pair"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [2, 4])
def test_up_operand_is_the_plain_operand(cuda, s, corner_mode, dt, source, cin):
    """The operand pass against ``up_operand_plain`` (the upsampled phases,
    the phase-pad poles, the zero row, channels padded to a multiple of 8):
    equal bit for bit, for a level-s grid (the up conv, d) and a joined pair
    (n), channel by channel (C_in 12) and 8 at a time (16): the pass runs
    gn::UpLoad's arithmetic, which rounds where the plain ops do."""
    if source == "grid":
        x, _, _ = _inputs(cuda, dt, s, cin, 20, seed=200 + s)
        got, ref = pk.up_operand(x, corner_mode), pk.up_operand_plain(x, corner_mode)
    else:
        b0, y10, aff = _pair(cuda, dt, s, cin, seed=210 + s)
        got = pk.up_pair_operand(b0, y10, aff, corner_mode)
        ref = pk.up_pair_operand_plain(b0, y10, aff, corner_mode)
    torch.cuda.synchronize()
    B, M = 2, 5 * 2**s * 2 ** (s + 1)
    assert got.shape == (B * (4 * M + 2) + 1, 16) and got.dtype == dt
    assert torch.equal(got, ref)
    assert not got[:, cin:].any() and not got[-1].any()


def _model_width_dtaps(cuda, kernel, fold):
    """bf16 inputs of one dtaps call at a site of the s=5 model (B=2): d at
    up1 (level-3 grid, 256 -> 2x128), n at up2 (level-4 pair, 128 -> 2x64)."""
    s, cin, cout = (3, 256, 128) if kernel == "d" else (4, 128, 64)
    dt = torch.bfloat16
    mk, gs = _stats_fold(cuda, dt, (2, 5, 2**s, 2 ** (s + 1), cout), 2, seed=220 + s)
    g = mk(4)
    fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
    if kernel == "d":
        x, _, _ = _inputs(cuda, dt, s, cin, cout, seed=230)
        return (lambda: pk.up_dual_conv_dtaps(x, g, "average", **fk),
                lambda: pk.up_dual_conv_dtaps_plain(x, g, "average", **fk))
    b0, y10, aff = _pair(cuda, dt, s, cin, seed=240)
    return (lambda: pk.up_pair_dtaps(b0, y10, aff, g, "average", **fk),
            lambda: pk.up_pair_dtaps_plain(b0, y10, aff, g, "average", **fk))


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("kernel", ["d", "n"])
def test_mma_dtaps_at_the_model_widths(cuda, kernel, fold):
    """d and n's bf16 dtaps at a site of the s=5 model, with the stats fold in
    the kernel and without, against the plain versions (autograd of the plain
    conv in float32): the products are exact and both sum in float32, so
    they differ by the order of the sums alone; held within 1e-3·max|ref|
    (float32 summation noise is about 1e-6 here), far inside TOL."""
    kernel_call, plain = _model_width_dtaps(cuda, kernel, fold)
    name = "up_dual_conv_dtaps" if kernel == "d" else "up_pair_dtaps"
    build.reset_launches()
    got = kernel_call()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == 1
    for u, v in zip(got, plain()):
        assert u.dtype == torch.float32 and bool(torch.isfinite(u).all())
        err, scale = (u - v).abs().max().item(), v.abs().max().item()
        assert err <= 1e-3 * scale, (err, scale)


@pytest.mark.parametrize("cin, cout", [(12, 20), (16, 64)])
def test_mma_dtaps_one_tap_set(cuda, cin, cout):
    """The up conv's bf16 dtaps with one tap set (N = C_out columns), with
    and without the fold, against its plain version: C_out 20 takes the
    element-by-element g loads, 64 the 16-byte copies."""
    x, _, _ = _inputs(cuda, torch.bfloat16, 2, cin, cout, seed=250 + cin)
    mk, gs = _stats_fold(cuda, torch.bfloat16, x.shape[:-1] + (cout,), 1, seed=cout)
    for fold in (True, False):
        g = mk(4)
        fk = dict(y_groups=mk(4), gs_list=gs) if fold else {}
        got = pk.up_dual_conv_dtaps(x, g, "average", **fk)
        assert len(got) == 1
        _close_all(got, pk.up_dual_conv_dtaps_plain(x, g, "average", **fk), torch.bfloat16)


def _bf16_step(cuda, model, plain=None, **routing):
    """One bf16 training forward and backward of the s=4 model on the default
    route (or on ``routing``, the model's ``merged_bwd`` / ``phase_chain``
    options); ``plain`` names a kernel wrapper that ``ops/kernels/fused.py``
    calls (``up_dual_conv_dtaps``, ``up_dual_conv_fwd``), or a tuple of them
    (``phase_conv_dtaps``, ``ico_conv_s2s_dtaps``), which then run their
    plain versions on the card tensors. (loss, launches, gradients)."""
    from unittest import mock

    import geniconet_tpu_torch.nn.models as models
    from geniconet_tpu_torch.ops.kernels import fused

    s, widths, latent = 4, (8, 16, 16), 8
    vae = model == "ico2ico_vae"
    variables = bridge.init_variables(s, widths, seed=4, random_stats=True, model=model,
                                      latent_features=latent)
    gen = torch.Generator().manual_seed(7)
    x = 0.5 * torch.randn(4, 5 * 2**s, 2 ** (s + 1), 3, generator=gen)
    eps = torch.randn(4, 5 * 2 ** (s - 3), 2 ** (s - 2), latent, generator=gen)
    tpack = torch.randn(4, 5, 2 ** (s - 1), 2**s, 12, generator=gen)
    tpoles = torch.randn(4, 6, generator=gen)
    cts = [torch.randn(x.shape, generator=gen), torch.randn(eps.shape, generator=gen),
           torch.randn(eps.shape, generator=gen)]
    kw = dict(dtype=torch.bfloat16, **routing)
    net = IcoVAE(s, widths, latent, **kw) if vae else IcoAE(s, widths, **kw)
    net.load_state_dict(bridge.flax_to_state_dict(variables))
    net.to(cuda)

    def fixed(mu, logvar, generator=None):
        std = torch.exp(0.5 * logvar)
        return eps.to(cuda, std.dtype) * std + mu

    patches = [mock.patch.object(models, "reparameterize", fixed)]
    for name in (plain,) if isinstance(plain, str) else plain or ():
        module = pk if hasattr(pk, f"{name}_plain") else ck
        patches.append(mock.patch.object(fused, name, getattr(module, f"{name}_plain")))
    build.reset_launches()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        if vae:
            outs = net(x.to(cuda), train=True)
            loss = sum((o.float() * c.to(cuda)).sum() for o, c in zip(outs, cts))
        else:
            loss = net.recon_sse(x.to(cuda), tpack.to(cuda), tpoles.to(cuda), train=True).sum()
        loss.backward()
    torch.cuda.synchronize()
    return loss.item(), dict(build.LAUNCHES), {k: p.grad.cpu() for k, p in net.named_parameters()}


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_mma_dtaps(cuda, model):
    """A bf16 training step of the default route with the tensor-core dtaps
    at up0-2, against the same step with the up conv's dtaps patched to its
    plain version on the card tensors. Only the up convs' taps gradients can
    differ: their float32 sums differ in order alone (about 1e-6 relative),
    then round to bf16 on both sides, so each element is within one bf16 ulp
    of the other: |got - ref| <= 2^-7·max|ref| (plus 1e-5·max|ref| of
    float32 noise). Every other gradient and the loss are equal bit for
    bit."""
    loss, launches, grads = _bf16_step(cuda, model)
    assert launches["up_dual_conv_dtaps"] == 3
    ref_loss, ref_launches, ref = _bf16_step(cuda, model, plain="up_dual_conv_dtaps")
    assert "up_dual_conv_dtaps" not in ref_launches
    assert loss == ref_loss
    up_taps = [k for k in grads if k.startswith("decoder.up") and
               (".conv00.taps" in k or ".conv10.taps" in k)]
    assert len(up_taps) == 6
    for k, g in grads.items():
        if k in up_taps:
            err, scale = (g - ref[k]).abs().max().item(), ref[k].abs().max().item()
            assert scale > 0 and err <= (2**-7 + 1e-5) * scale, (k, err, scale)
        else:
            assert torch.equal(g, ref[k]), k


def test_mma_dtaps_occupancy(cuda):
    """Each instantiation of the tensor-core GEMM (d and n, fold or not)
    fits 2 blocks an SM with no local memory (no spill)."""
    for pair in (False, True):
        for fold in (False, True):
            info = build.mma_dtaps_info(pair, fold)
            assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (pair, fold, info)


# ---------------------------------------------------------------------------
# the bf16 forward of the up conv and of n on the tensor cores: the operand
# pass, the taps packed once, then the GEMM with the stats epilogue
# ---------------------------------------------------------------------------

# (level s of the input grid, C_in, C_out) of the s=5 models' up convs: the
# AE's up0-2 and the VAE's up0 (from its 512-channel latent)
MODEL_UPS = {"AE up0": (2, 256, 256), "AE up1": (3, 256, 128), "AE up2": (4, 128, 64),
             "VAE up0": (2, 512, 256)}


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("site", list(MODEL_UPS))
def test_mma_fwd_at_the_model_widths(cuda, site, with_stats):
    """The up conv's bf16 forward at a site of the s=5 models (B=2) against
    its plain version (float32 sums, then bf16): the products are exact and
    both sum in float32, so each output is within one bf16 ulp of its
    max|ref| (``_within_ulp``); the stats, sums of those outputs, within
    TOL."""
    s, cin, cout = MODEL_UPS[site]
    x, _, sets = _inputs(cuda, torch.bfloat16, s, cin, cout, seed=260 + s)
    build.reset_launches()
    got = pk.up_dual_conv_fwd(x, sets, "average", with_stats)
    torch.cuda.synchronize()
    assert build.LAUNCHES["up_dual_conv_fwd"] == 1
    ref = pk.up_dual_conv_fwd_plain(x, sets, "average", with_stats)
    outs, ref_outs = (got[0], ref[0]) if with_stats else (got, ref)
    _within_ulp(outs, ref_outs)
    if with_stats:
        _close_all(got[1], ref[1], torch.bfloat16)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("cin, cout", [(12, 20), (16, 64), (20, 9)])
def test_mma_fwd_tap_sets_and_widths(cuda, cin, cout, corner_mode):
    """The bf16 forward with 1 and 2 tap sets, with and without stats, at
    widths the model has not: C_in 12 and 20 (the operand's ragged channel
    pass; a 32-channel step half past C_in), C_out 20 (two sets in one
    column tile), 9 (odd: one-column stores) and a bias of None, against
    its plain version (``_within_ulp`` on the outputs, TOL on the stats);
    without stats the outputs are the same GEMM's, bit for bit."""
    x, _, sets = _inputs(cuda, torch.bfloat16, 3, cin, cout, seed=270 + cin)
    for tap_sets in (sets, sets[:1], [(sets[0][0], None)]):
        got, stats = pk.up_dual_conv_fwd(x, tap_sets, corner_mode, True)
        ref, ref_stats = pk.up_dual_conv_fwd_plain(x, tap_sets, corner_mode, True)
        assert len(got) == len(tap_sets)
        _within_ulp(got, ref)
        _equal_all(pk.up_dual_conv_fwd(x, tap_sets, corner_mode), got)
        _close_all(stats, ref_stats, torch.bfloat16)


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_mma_fwd(cuda, model):
    """A bf16 training step of the default route with the tensor-core
    forward at up0-2, against the same step with the up conv's forward
    patched to its plain version on the card tensors. The two forwards
    differ by at most one bf16 ulp an output (float32 sums in another
    order), and those roundings carry through the BatchNorms, nine later
    convs and the backward: the loss within 1e-2 of its value and every
    gradient within 5e-2·max|ref| (the tolerance of
    ``test_model_kernel_route_matches_plain_route`` for bf16 roundings that
    compound through the model), but for the conv biases: each feeds a
    BatchNorm, so its exact gradient is 0 and it is held against its taps'
    scale, as ``test_merged_block_step_equals_the_split_route`` does."""
    loss, launches, grads = _bf16_step(cuda, model)
    assert launches["up_dual_conv_fwd"] == 3
    ref_loss, ref_launches, ref = _bf16_step(cuda, model, plain="up_dual_conv_fwd")
    assert "up_dual_conv_fwd" not in ref_launches
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    worst = _step_rel(grads, ref)[:5]
    assert worst[0][1] <= 5e-2, worst


def test_mma_fwd_has_no_fallback(cuda):
    """A bf16 call whose operand scratch is missing raises (the C entry
    refuses it) rather than running the SIMT core."""
    from unittest import mock

    x, _, sets = _inputs(cuda, torch.bfloat16, 2, 16, 8, seed=280)
    scratch = pk.fwd_scratch

    def without_operand(*args):
        stats, ws, _, wpack = scratch(*args)
        return stats, ws, None, wpack

    with mock.patch.object(pk, "fwd_scratch", without_operand):
        with pytest.raises(RuntimeError, match="up_dual_conv_fwd"):
            pk.up_dual_conv_fwd(x, sets)
        b0, y10, aff = _pair(cuda, torch.bfloat16, 2, 16, seed=281)
        with pytest.raises(RuntimeError, match="up_pair_fwd"):
            pk.up_pair_fwd(b0, y10, aff, sets)


def test_mma_fwd_occupancy(cuda):
    """Each instantiation of the tensor-core forward GEMM (the up conv and n,
    with stats or not) fits 2 blocks an SM with no local memory (no
    spill)."""
    for pair in (False, True):
        for stats in (False, True):
            info = build.mma_fwd_info(pair, stats)
            assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (pair, stats, info)


# ---------------------------------------------------------------------------
# the bf16 dtaps of the grid convs (b: the phase conv, f: the standard conv)
# on the tensor cores: the act-applied operand pass, then the GEMM over its
# gathered rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_act", [True, False])
@pytest.mark.parametrize("cin", [12, 16])
@pytest.mark.parametrize("n_src", [4, 1])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("s", [2, 4])
def test_grid_operand_is_the_plain_operand(cuda, s, corner_mode, dt, n_src, cin, with_act):
    """The grid convs' operand pass against ``grid_operand_plain`` (the
    act-applied sources, each sample's two poles, the zero row, channels
    padded to a multiple of 8): equal bit for bit, for the phase conv's 4
    phases and the standard conv's grid, channel by channel (C_in 12) and 8
    at a time (16): the pass runs GridLoad's act and pole arithmetic, which
    rounds where the plain ops do."""
    x, act, _ = _inputs(cuda, dt, s, cin, 8, seed=300 + s + cin)
    sources = _split(x) if n_src == 4 else (x,)
    a = act if with_act else None
    got = pk.grid_operand(sources, a, corner_mode)
    torch.cuda.synchronize()
    ref = pk.grid_operand_plain(sources, a, corner_mode)
    h, w = sources[0].shape[2:4]
    assert got.shape == (pk.grid_operand_rows(2, h, w, n_src), 16) and got.dtype == dt
    assert torch.equal(got, ref)
    assert not got[:, cin:].any() and not got[-1].any()


# The grid convs' dtaps at the s=5 models' training shapes (B=2): (kernel,
# phase h, w, C_in, C_out, tap sets, output phases, act); b's conv_in,
# conv01 of up0-2 and the stride-2 convs of down0-2 (with an act prologue
# at down0 only in the AE; both kinds at down1-2) and the VAE's heads, f's
# conv01 of down0-2
GRID_DTAPS = {
    "conv_in": ("b", 16, 32, 3, 64, 1, (0, 1, 2, 3), False),
    "up0 conv01": ("b", 4, 8, 256, 256, 1, (0, 1, 2, 3), True),
    "up1 conv01": ("b", 8, 16, 128, 128, 1, (0, 1, 2, 3), True),
    "up2 conv01": ("b", 16, 32, 64, 64, 1, (0, 1, 2, 3), True),
    "down0 s2": ("b", 16, 32, 64, 128, 2, (2,), True),
    "down1 s2": ("b", 8, 16, 128, 256, 2, (2,), True),
    "down1 s2 (no act)": ("b", 8, 16, 128, 256, 2, (2,), False),
    "down2 s2": ("b", 4, 8, 256, 256, 2, (2,), True),
    "down2 s2 (no act)": ("b", 4, 8, 256, 256, 2, (2,), False),
    "VAE heads": ("b", 4, 8, 256, 512, 2, (2,), False),
    "down0 conv01": ("f", 16, 32, 128, 128, 1, (0,), True),
    "down1 conv01": ("f", 8, 16, 256, 256, 1, (0,), True),
    "down2 conv01": ("f", 4, 8, 256, 256, 1, (0,), True),
}


def _grid_dtaps_calls(cuda, case, fold, corner_mode="average", seed=0):
    """(kernel call, plain call) of b or f at a GRID_DTAPS shape, bf16, B=2,
    with the stats fold in the kernel or without (b then emits Σg_eff)."""
    kernel, h, w, cin, cout, n_sets, out_phases, with_act = case
    dt, B = torch.bfloat16, 2
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda, dt)

    act = ((torch.rand(cin, generator=gen) + 0.5).to(cuda),
           (0.3 * torch.randn(cin, generator=gen)).to(cuda)) if with_act else None
    shape = (B, 5, h, w, cout)
    gs = [(1e-3 * torch.randn(2, cout, generator=gen)).to(cuda) for _ in range(n_sets)]
    if kernel == "f":
        x, g, y = rnd(B, 5, h, w, cin), rnd(*shape), rnd(*shape)
        fk = dict(y=y, gs=gs[0]) if fold else {}
        return (lambda: ck.ico_conv_s2s_dtaps(x, g, corner_mode, act, **fk),
                lambda: ck.ico_conv_s2s_dtaps_plain(x, g, corner_mode, act, **fk))
    phases = [rnd(B, 5, h, w, cin) for _ in range(4)]
    g = [[rnd(*shape) for _ in out_phases] for _ in range(n_sets)]
    fk = dict(y_groups=[[rnd(*shape) for _ in out_phases] for _ in range(n_sets)],
              gs_list=gs) if fold else {}
    args = (phases, g, [(7, cin, cout)] * n_sets, corner_mode, out_phases, act)
    return (lambda: pk.phase_conv_dtaps(*args, **fk, emit_gsum=not fold),
            lambda: pk.phase_conv_dtaps_plain(*args, **fk, emit_gsum=not fold))


def _check_grid_dtaps(got, ref, kernel):
    """b's float32 dtaps (and Σg_eff) within 1e-3·max|ref|: the products
    are exact and both sides sum in float32, in two orders (about 1e-6 of
    noise), far inside TOL; f's, rounded to bf16 on both sides, within one
    bf16 ulp of max|ref| (``_within_ulp``)."""
    if kernel == "f":
        _within_ulp([got], [ref])
        return
    for u, v in zip(_flat_all(got), _flat_all(ref)):
        assert u.dtype == torch.float32 and bool(torch.isfinite(u).all())
        err, scale = (u - v).abs().max().item(), v.abs().max().item()
        assert err <= 1e-3 * scale, (err, scale)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("site", list(GRID_DTAPS))
def test_mma_grid_dtaps_at_the_model_widths(cuda, site, fold):
    """b and f in bf16 at every training shape of the s=5 AE and VAE (B=2),
    with the stats fold in the kernel and without, against their plain
    versions (``_check_grid_dtaps``); C_in 3 (conv_in: all 7 taps a block)
    and 64 (up2 conv01, down0 s2: 2 taps a block) take the NARROW tile. One
    launch of the wrapper each."""
    case = GRID_DTAPS[site]
    call, plain = _grid_dtaps_calls(cuda, case, fold, seed=len(site))
    name = "ico_conv_s2s_dtaps" if case[0] == "f" else "phase_conv_dtaps"
    build.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 1}
    _check_grid_dtaps(got, plain(), case[0])


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("cin, cout", [(12, 20), (20, 9), (100, 24)])
@pytest.mark.parametrize("kind", ["b s1", "b s2", "f"])
def test_mma_grid_dtaps_ragged_widths(cuda, kind, cin, cout, corner_mode):
    """b (4 output phases, one set; phase 2, two sets) and f at widths the
    model has not, with and without the fold and the act: C_in 12 (the
    NARROW tile, all 7 taps of two chunks a block), 20 (NARROW, 5 taps of
    three chunks a block, the last block 2) and 100 (the wide tile, past
    C_in), each through the operand's ragged channel pass; C_out 20 and 9
    (the element-by-element g loads) and 24, against their plain versions
    (``_check_grid_dtaps``)."""
    kernel = kind[0]
    n_sets, out_phases = (2, (2,)) if kind == "b s2" else (1, (0, 1, 2, 3))
    for fold, with_act in ((True, True), (False, False), (True, False)):
        case = (kernel, 8, 16, cin, cout, n_sets, out_phases, with_act)
        call, plain = _grid_dtaps_calls(cuda, case, fold, corner_mode, seed=cin + cout)
        _check_grid_dtaps(call(), plain(), kernel)


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_mma_grid_dtaps(cuda, model):
    """A bf16 training step of the default route with the tensor-core dtaps
    of the phase conv (b) and the standard conv (f), against the same step
    with both patched to their plain versions on the card tensors. Only the
    taps gradients b and f compute can differ (13 in the AE: conv_in, up0-2
    conv01, down0-2 conv00/conv10 and conv01; 12 in the VAE: its 2
    DownBlocks, the mu/logvar heads instead of down2): their float32 sums
    differ in order alone, then round to bf16 on both sides, so each is
    within one bf16 ulp of max|ref| (plus 1e-5·max|ref| of float32 noise).
    Every other gradient and the loss are equal bit for bit."""
    loss, launches, grads = _bf16_step(cuda, model)
    assert launches["phase_conv_dtaps"] == 7 and launches["ico_conv_s2s_dtaps"] > 0
    plain = ("phase_conv_dtaps", "ico_conv_s2s_dtaps")
    ref_loss, ref_launches, ref = _bf16_step(cuda, model, plain=plain)
    assert not set(plain) & set(ref_launches)
    assert loss == ref_loss
    up = [k for k in grads if k.startswith("decoder.up") and
          (".conv00.taps" in k or ".conv10.taps" in k)]
    grid_taps = [k for k in grads if k.endswith(".taps") and k not in up]
    assert len(grid_taps) == (12 if model == "ico2ico_vae" else 13), grid_taps
    for k, g in grads.items():
        if k in grid_taps:
            err, scale = (g - ref[k]).abs().max().item(), ref[k].abs().max().item()
            assert scale > 0 and err <= (2**-7 + 1e-5) * scale, (k, err, scale)
        else:
            assert torch.equal(g, ref[k]), k


def test_mma_grid_dtaps_has_no_fallback(cuda):
    """A bf16 call of b or f whose operand scratch is missing raises (the C
    entry refuses it) rather than running the SIMT core."""
    from unittest import mock

    def without_operand(scratch):
        return lambda *args: (*scratch(*args)[:3], None)

    case_b, case_f = GRID_DTAPS["up2 conv01"], GRID_DTAPS["down2 conv01"]
    with mock.patch.object(pk, "grid_dtaps_scratch", without_operand(pk.grid_dtaps_scratch)):
        with pytest.raises(RuntimeError, match="phase_conv_dtaps"):
            _grid_dtaps_calls(cuda, case_b, True)[0]()
    with mock.patch.object(ck, "grid_dtaps_scratch", without_operand(ck.grid_dtaps_scratch)):
        with pytest.raises(RuntimeError, match="ico_conv_s2s_dtaps"):
            _grid_dtaps_calls(cuda, case_f, True)[0]()


def test_mma_grid_dtaps_occupancy(cuda):
    """Each instantiation of the grid convs' tensor-core GEMM (b and f, fold
    or not, NARROW or wide) fits 2 blocks an SM with no local memory (no
    spill)."""
    for std in (False, True):
        for fold in (False, True):
            for narrow in (False, True):
                info = build.grid_dtaps_info(std, fold, narrow)
                assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (
                    std, fold, narrow, info)


# ---------------------------------------------------------------------------
# the bf16 forward of the grid convs (the phase conv and the standard conv)
# on the tensor cores: the act-applied operand pass, the taps packed, then the
# GEMM with the stats epilogue
# ---------------------------------------------------------------------------

# The grid convs' forward at the s=5 models' shapes: (kernel, phase or grid
# h, w, C_in, C_out, tap sets, output phases, act): conv_in, down0-2's
# stride-2 convs (with the act at down0 only in the AE; both kinds at
# down1-2), up0-2 conv01, the VAE's heads; the standard conv's conv01 of
# down0-2
GRID_FWD = {
    "conv_in": ("b", 16, 32, 3, 64, 1, (0, 1, 2, 3), False),
    "down0 s2": ("b", 16, 32, 64, 128, 2, (2,), True),
    "down1 s2": ("b", 8, 16, 128, 256, 2, (2,), True),
    "down1 s2 (no act)": ("b", 8, 16, 128, 256, 2, (2,), False),
    "down2 s2": ("b", 4, 8, 256, 256, 2, (2,), True),
    "down2 s2 (no act)": ("b", 4, 8, 256, 256, 2, (2,), False),
    "VAE heads": ("b", 4, 8, 256, 512, 2, (2,), False),
    "up0 conv01": ("b", 4, 8, 256, 256, 1, (0, 1, 2, 3), True),
    "up1 conv01": ("b", 8, 16, 128, 128, 1, (0, 1, 2, 3), True),
    "up2 conv01": ("b", 16, 32, 64, 64, 1, (0, 1, 2, 3), True),
    "down0 conv01": ("f", 16, 32, 128, 128, 1, None, True),
    "down1 conv01": ("f", 8, 16, 256, 256, 1, None, True),
    "down2 conv01": ("f", 4, 8, 256, 256, 1, None, True),
}


def _grid_fwd_calls(cuda, case, with_stats, corner_mode="average", seed=0, bias=True):
    """(kernel call, plain call, wrapper name) of the phase conv's or the
    standard conv's forward at a GRID_FWD-shaped case, bf16, B=2."""
    kernel, h, w, cin, cout, n_sets, out_phases, with_act = case
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    act = ((torch.rand(cin, generator=gen) + 0.5).to(cuda),
           (0.3 * torch.randn(cin, generator=gen)).to(cuda)) if with_act else None
    sets = [((torch.randn(7, cin, cout, generator=gen) * (7 * cin) ** -0.5).to(cuda, dt),
             torch.randn(cout, generator=gen).to(cuda, dt) if bias else None)
            for _ in range(n_sets)]
    if kernel == "f":
        x = torch.randn(2, 5, h, w, cin, generator=gen).to(cuda, dt)
        args = (x, *sets[0], corner_mode, act, with_stats)
        return (lambda: ck.ico_conv_s2s_fwd(*args), lambda: ck.ico_conv_s2s_fwd_plain(*args),
                "ico_conv_s2s_fwd")
    phases = [torch.randn(2, 5, h, w, cin, generator=gen).to(cuda, dt) for _ in range(4)]
    args = (phases, sets, corner_mode, out_phases, act, with_stats)
    return (lambda: pk.phase_conv_fwd(*args), lambda: pk.phase_conv_fwd_plain(*args),
            "phase_conv_fwd")


def _check_grid_fwd(got, ref, with_stats):
    """The bf16 outputs within one bf16 ulp of max|ref| (``_within_ulp``: the
    products are exact and both sides sum in float32, in two orders, then
    round); the stats, sums of those outputs, within TOL."""
    outs, ref_outs = (got[0], ref[0]) if with_stats else (got, ref)
    assert all(bool(torch.isfinite(t).all()) for t in _flat_all(outs))
    _within_ulp(outs, ref_outs)
    if with_stats:
        _close_all(got[1], ref[1], torch.bfloat16)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("site", list(GRID_FWD))
def test_mma_grid_fwd_at_the_model_widths(cuda, site, with_stats):
    """The phase conv's and the standard conv's bf16 forward at every site
    of the s=5 AE and VAE (B=2), with stats and without, against their
    plain versions (``_check_grid_fwd``). One launch of the wrapper each."""
    call, plain, name = _grid_fwd_calls(cuda, GRID_FWD[site], with_stats, seed=len(site))
    build.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 1}
    _check_grid_fwd(got, plain(), with_stats)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("cin, cout", [(3, 20), (5, 64), (12, 20), (12, 64)])
@pytest.mark.parametrize("kind", ["b s1", "b s2", "f"])
def test_mma_grid_fwd_ragged_widths(cuda, kind, cin, cout, corner_mode):
    """The grid convs' bf16 forward at widths the model has not: C_in 3, 5
    and 12 (the operand's ragged channel pass; a 32-channel step mostly past
    C_in), C_out 20 (two sets in one column tile) and 64 (half a tile), with
    and without the act, the stats and the bias, against the plain
    versions (``_check_grid_fwd``); without stats the outputs are the same
    GEMM's as with them, bit for bit."""
    n_sets, out_phases = {"b s1": (1, (0, 1, 2, 3)), "b s2": (2, (2,)), "f": (1, None)}[kind]
    for with_act, bias in ((True, True), (False, False)):
        case = (kind[0], 8, 16, cin, cout, n_sets, out_phases, with_act)
        call, plain, _ = _grid_fwd_calls(cuda, case, True, corner_mode, cin + cout, bias)
        got = call()
        _check_grid_fwd(got, plain(), True)
        no_stats, _, _ = _grid_fwd_calls(cuda, case, False, corner_mode, cin + cout, bias)
        _equal_all(_flat_all(no_stats()), _flat_all(got[0]))


def _step_rel(grads, ref):
    """Per gradient, max|got - ref| over max|ref| (a conv bias over its
    taps': each feeds a BatchNorm, so its exact gradient is 0)."""
    rel = {}
    for k, g in grads.items():
        scale_of = k[: -len("bias")] + "taps" if "conv" in k and k.endswith(".bias") else k
        err = (g.float() - ref[k].float()).abs().max().item()
        rel[k] = err / ref[scale_of].float().abs().max().item()
    return sorted(rel.items(), key=lambda kv: -kv[1])


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_mma_grid_fwd(cuda, model):
    """A bf16 training step of the default route with the tensor-core
    forward of the phase conv and the standard conv. In the step, every
    call of the two wrappers agrees with its plain version on that call's
    own inputs: outputs within one bf16 ulp of max|ref| (``_within_ulp``),
    stats within TOL. Against the same step with both patched to their
    plain versions on the card tensors: the loss within 1e-2 of its value.
    The gradients are not compared: a few thousandths of the forward's
    outputs round one bf16 ulp the other way, and this B=4 model's
    BatchNorms move its gradients by a share of max|ref| that depends on
    which outputs flipped, as much for a forward summed in float64 as for
    this one (``scripts/torch_step_grad_spread.py``)."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    calls = []

    def checked(kernel, plain):
        def fn(*args, **kwargs):  # ``fused`` passes with_stats last, the stride by name
            got = kernel(*args, **kwargs)
            calls.append((got, plain(*args, **kwargs), args[-1]))
            return got
        return fn

    with mock.patch.object(fused, "phase_conv_fwd",
                           checked(pk.phase_conv_fwd, pk.phase_conv_fwd_plain)), \
            mock.patch.object(fused, "ico_conv_s2s_fwd",
                              checked(ck.ico_conv_s2s_fwd, ck.ico_conv_s2s_fwd_plain)):
        loss, launches, grads = _bf16_step(cuda, model)
    vae = model == "ico2ico_vae"
    assert launches["phase_conv_fwd"] == 7 and launches["ico_conv_s2s_fwd"] == (2 if vae else 3)
    assert len(calls) == (9 if vae else 10)
    for got, ref, with_stats in calls:
        _check_grid_fwd(got, ref, with_stats)
    plain = ("phase_conv_fwd", "ico_conv_s2s_fwd")
    ref_loss, ref_launches, _ = _bf16_step(cuda, model, plain=plain)
    assert not set(plain) & set(ref_launches)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_mma_grid_fwd_has_no_fallback(cuda):
    """A bf16 call of either grid forward whose operand or packed-taps
    scratch is missing raises (the C entry refuses it) rather than running
    the SIMT core."""
    from unittest import mock

    def without(i, scratch):
        def fn(*args):
            out = list(scratch(*args))
            out[i] = None
            return tuple(out)
        return fn

    cases = {"phase_conv_fwd": (pk, GRID_FWD["up2 conv01"]),
             "ico_conv_s2s_fwd": (ck, GRID_FWD["down2 conv01"])}
    for name, (module, case) in cases.items():
        call = _grid_fwd_calls(cuda, case, True)[0]
        for i in (2, 3):  # the operand, the packed taps
            with mock.patch.object(module, "fwd_scratch", without(i, module.fwd_scratch)):
                with pytest.raises(RuntimeError, match=name):
                    call()


def test_mma_grid_fwd_occupancy(cuda):
    """Each instantiation of the grid convs' tensor-core forward GEMM (the
    phase conv and the standard conv, with stats or not) fits 2 blocks an
    SM with no local memory (no spill)."""
    for std in (False, True):
        for stats in (False, True):
            info = build.grid_fwd_info(std, stats)
            assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (std, stats, info)


# ---------------------------------------------------------------------------
# the bf16 input gradients of the phase conv (a) and the up conv (c) on the
# tensor cores: the folded cotangent written once with its combined rows,
# then the forward's GEMM over a transposed code table (c: into float32 dU,
# then the upsample adjoint)
# ---------------------------------------------------------------------------

# a, c and f at the s=5 models' shapes: (kernel, cotangent h, w, C_in,
# C_out, tap sets, output phases, act): up0-2 conv01 (stride 1, act);
# down0-2's stride-2 convs (act at down0; down1-2 with and without, as the
# AE runs them); the VAE's heads; the up convs up0-2 and the VAE's up0;
# the standard conv (f; output phases None) at down0-2 conv01
GRID_DX = {
    "up0 conv01": ("a", 4, 8, 256, 256, 1, (0, 1, 2, 3), True),
    "up1 conv01": ("a", 8, 16, 128, 128, 1, (0, 1, 2, 3), True),
    "up2 conv01": ("a", 16, 32, 64, 64, 1, (0, 1, 2, 3), True),
    "down0 s2": ("a", 16, 32, 64, 128, 2, (2,), True),
    "down1 s2": ("a", 8, 16, 128, 256, 2, (2,), True),
    "down1 s2 (no act)": ("a", 8, 16, 128, 256, 2, (2,), False),
    "down2 s2": ("a", 4, 8, 256, 256, 2, (2,), True),
    "down2 s2 (no act)": ("a", 4, 8, 256, 256, 2, (2,), False),
    "VAE heads": ("a", 4, 8, 256, 512, 2, (2,), False),
    "up0": ("c", 4, 8, 256, 256, 2, (0, 1, 2, 3), False),
    "up1": ("c", 8, 16, 256, 128, 2, (0, 1, 2, 3), False),
    "up2": ("c", 16, 32, 128, 64, 2, (0, 1, 2, 3), False),
    "VAE up0": ("c", 4, 8, 512, 256, 2, (0, 1, 2, 3), False),
    "down0 conv01": ("f", 16, 32, 128, 128, 1, None, True),
    "down1 conv01": ("f", 8, 16, 256, 256, 1, None, True),
    "down2 conv01": ("f", 4, 8, 256, 256, 1, None, True),
    "down2 conv01 (no act)": ("f", 4, 8, 256, 256, 1, None, False),
}


def _dx_calls(cuda, case, fold, corner_mode="average", seed=0):
    """(kernel call, plain call, wrapper name) of a's, c's or f's dx at a
    GRID_DX-shaped case, bf16, B=2 (Σg_eff with the fold, and always for c)."""
    kernel, h, w, cin, cout, n_sets, out_phases, with_act = case
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    sets = [((torch.randn(7, cin, cout, generator=gen) * (7 * cin) ** -0.5).to(cuda, dt), None)
            for _ in range(n_sets)]
    n_out = 1 if out_phases is None else len(out_phases)

    def group():
        return [[torch.randn(2, 5, h, w, cout, generator=gen).to(cuda, dt) for _ in range(n_out)]
                for _ in range(n_sets)]

    g = group()
    fk = dict(y_groups=group(), gs_list=[(1e-3 * torch.randn(2, cout, generator=gen)).to(cuda)
                                         for _ in range(n_sets)]) if fold else {}
    if kernel == "c":
        args = (g, sets, corner_mode, dt)
        return (lambda: pk.up_dual_conv_dx(*args, **fk, emit_gsum=True),
                lambda: pk.up_dual_conv_dx_plain(*args, **fk, emit_gsum=True), "up_dual_conv_dx")
    act = ((torch.rand(cin, generator=gen) + 0.5).to(cuda),
           (0.3 * torch.randn(cin, generator=gen)).to(cuda)) if with_act else None
    raw = [torch.randn(2, 5, h, w, cin, generator=gen).to(cuda, dt) for _ in range(4)]
    if kernel == "f":
        args = (g[0][0], sets[0][0], corner_mode, dt, act, raw[0] if with_act else None,
                *((fk["y_groups"][0][0], fk["gs_list"][0]) if fold else (None, None)), fold)
        return (lambda: ck.ico_conv_s2s_dx(*args), lambda: ck.ico_conv_s2s_dx_plain(*args),
                "ico_conv_s2s_dx")
    args = (g, sets, corner_mode, out_phases, cin, dt, act, raw if with_act else None)
    return (lambda: pk.phase_conv_dx(*args, **fk), lambda: pk.phase_conv_dx_plain(*args, **fk),
            "phase_conv_dx")


def _check_dx(got, ref):
    """dx within one bf16 ulp of max|ref| (``_within_ulp``: the products are
    exact, both sides sum in float32 in two orders and round once; the
    combined rows round their few-term sums once more, well inside); d_mul,
    d_add and Σg_eff (float32 sums) within TOL."""
    dx, ref_dx = (got[0], ref[0])
    assert all(bool(torch.isfinite(t).all()) for t in _flat_all(dx))
    _within_ulp(dx, ref_dx)
    _close_all(got[1:], ref[1:], torch.bfloat16)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("site", list(GRID_DX))
def test_mma_dx_at_the_model_widths(cuda, site, fold):
    """a, c and f in bf16 at every site of the s=5 AE and VAE (B=2), with
    the stats fold and without, against their plain versions
    (``_check_dx``). One launch of the wrapper each."""
    call, plain, name = _dx_calls(cuda, GRID_DX[site], fold, seed=len(site))
    build.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {name: 1}
    _check_dx(got, plain())


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("cin, cout", [(12, 20), (20, 9), (100, 24), (5, 64)])
@pytest.mark.parametrize("kind", ["a s1", "a s2", "c", "f"])
def test_mma_dx_ragged_widths(cuda, kind, cin, cout, corner_mode):
    """a, c and f in bf16 at widths the model has not: C_in 5 and 100 (an
    odd and a ragged epilogue), C_out 9 and 20 (the cotangent pass channel
    by channel; two sets in one 32-column K step), at levels 1 and 3 (no
    tap masks at level 1: 4·5hw = 160 rows, f's 5hw = 40, several samples
    in one 128-row tile), with and without the act and the fold, against
    the plain versions (``_check_dx``)."""
    n_sets, out_phases = {"a s1": (1, (0, 1, 2, 3)), "a s2": (2, (2,)),
                          "c": (2, (0, 1, 2, 3)), "f": (1, None)}[kind]
    for s, with_act, fold in ((3, True, True), (1, False, False)):
        case = (kind[0], 2**s, 2 ** (s + 1), cin, cout, n_sets, out_phases, with_act)
        call, plain, _ = _dx_calls(cuda, case, fold, corner_mode, cin + cout + s)
        _check_dx(call(), plain())


def test_mma_dx_has_no_fallback(cuda):
    """A bf16 call of a, c, f or n whose cotangent operand, packed taps, dU
    or code table (for f also its combined rows or its tap masks; for n its
    adjoint table) is missing raises (the C entry refuses it) rather than
    running the SIMT dx_gemm."""
    from unittest import mock

    def without(i, fn):
        def wrapped(*args, **kwargs):
            out = list(fn(*args, **kwargs))
            if isinstance(out[0], tuple):  # dx_tables: (pointers, combined rows)
                out[0] = tuple(None if j == i else t for j, t in enumerate(out[0]))
            else:
                out[i] = None
            return tuple(out)
        return wrapped

    for site, name, drops in (("up2 conv01", "phase_conv_dx", (1, 2)),
                              ("up2", "up_dual_conv_dx", (1, 2, 3))):
        call = _dx_calls(cuda, GRID_DX[site], True)[0]
        for i in drops:  # the operand, the packed taps, dU
            with mock.patch.object(pk, "dx_scratch", without(i, pk.dx_scratch)):
                with pytest.raises(RuntimeError, match=name):
                    call()
        with mock.patch.object(pk, "dx_tables", without(3, pk.dx_tables)):  # the codes
            with pytest.raises(RuntimeError, match=name):
                call()
    b0, y10, aff = _pair(cuda, torch.bfloat16, 3, 12, seed=5)
    _, _, sets = _inputs(cuda, torch.bfloat16, 3, 12, 20, seed=6)
    mk, gs = _stats_fold(cuda, torch.bfloat16, (2, 5, 8, 16, 20), 2, seed=7)
    g, y = mk(4), mk(4)

    def pair_dx():
        return pk.up_pair_dx(g, b0, y10, aff, sets, "average", y, gs, True)

    pair_dx()
    for i in (1, 2, 3):  # the operand, the packed taps, dU
        with mock.patch.object(pk, "dx_scratch", without(i, pk.dx_scratch)):
            with pytest.raises(RuntimeError, match="up_pair_dx"):
                pair_dx()
    with mock.patch.object(pk, "dx_tables", without(3, pk.dx_tables)):  # the codes
        with pytest.raises(RuntimeError, match="up_pair_dx"):
            pair_dx()
    table = pk.device_dx_table
    with mock.patch.object(pk, "device_dx_table",  # the adjoint table
                           lambda kind, *a: (None,) * 3 if kind == "up_adjoint" else table(
                               kind, *a)):
        with pytest.raises(RuntimeError, match="up_pair_dx"):
            pair_dx()
    call = _dx_calls(cuda, GRID_DX["down0 conv01"], True)[0]
    for i in (1, 2):  # the operand, the packed taps
        with mock.patch.object(ck, "dx_scratch", without(i, ck.dx_scratch)):
            with pytest.raises(RuntimeError, match="ico_conv_s2s_dx"):
                call()
    for i in (3, 4, 7):  # the codes, the combined rows, the tap masks
        with mock.patch.object(ck, "dx_tables", without(i, ck.dx_tables)):
            with pytest.raises(RuntimeError, match="ico_conv_s2s_dx"):
                call()


def test_mma_dx_occupancy(cuda):
    """Each instantiation of the dx GEMM (a and f with the act epilogue and
    without, c, n) fits 2 blocks an SM with no local memory (no spill)."""
    for up, act, std in ((False, True, False), (False, False, False), (True, False, False),
                         (False, True, True), (False, False, True)):
        info = build.mma_dx_info(up, act, std)
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (up, act, std, info)
    info = build.mma_dx_info(True, pair=True)
    assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, info
    assert info == build.mma_dx_info(True)  # c's GEMM, tagged PairCells


def _dx_kernel_names(fn):
    """Kernel name -> launches in a profiler trace of fn()."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events() if e.device_type.name == "CUDA")


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_mma_dx(cuda, model):
    """A bf16 training step of the default route with the tensor-core dx of
    the phase conv (a), the up conv (c) and the standard conv (f). In the
    step, every call of the three wrappers agrees with its plain version on
    that call's own inputs (``_check_dx``); against the same step with all
    three patched to their plain versions on the card tensors, the loss
    within 1e-2 of its value (the gradients are not compared: see
    ``test_bf16_step_with_the_mma_grid_fwd``). A trace of the step shows the
    tensor-core GEMM once a call of a, c and f, and no SIMT dx_gemm<bf16>."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    calls = []

    def checked(kernel, plain):
        def fn(*args, **kwargs):
            got = kernel(*args, **kwargs)
            calls.append((got, plain(*args, **kwargs)))
            return got
        return fn

    with mock.patch.object(fused, "phase_conv_dx",
                           checked(pk.phase_conv_dx, pk.phase_conv_dx_plain)), \
            mock.patch.object(fused, "up_dual_conv_dx",
                              checked(pk.up_dual_conv_dx, pk.up_dual_conv_dx_plain)), \
            mock.patch.object(fused, "ico_conv_s2s_dx",
                              checked(ck.ico_conv_s2s_dx, ck.ico_conv_s2s_dx_plain)):
        loss, launches, grads = _bf16_step(cuda, model)
    vae = model == "ico2ico_vae"
    n_f = 2 if vae else 3
    assert launches["phase_conv_dx"] == 6 and launches["up_dual_conv_dx"] == 3
    assert launches["ico_conv_s2s_dx"] == n_f
    assert len(calls) == 9 + n_f
    for got, ref in calls:
        _check_dx(got, ref)
    plain = ("phase_conv_dx", "up_dual_conv_dx", "ico_conv_s2s_dx")
    ref_loss, ref_launches, _ = _bf16_step(cuda, model, plain=plain)
    assert not set(plain) & set(ref_launches)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    names = _dx_kernel_names(lambda: _bf16_step(cuda, model))
    count = {k: sum(n for name, n in names.items() if all(p in name for p in k))
             for k in (("mma_conv", "DxEpi", "PhaseGrid"), ("mma_conv", "DxEpi", "StdGrid"),
                       ("mma_conv", "DuEpi"), ("dx_gemm", "bfloat16"))}
    assert count[("mma_conv", "DxEpi", "PhaseGrid")] == 6, count
    assert count[("mma_conv", "DxEpi", "StdGrid")] == n_f, count
    assert count[("mma_conv", "DuEpi")] == 3, count
    assert count[("dx_gemm", "bfloat16")] == 0, count


# ---------------------------------------------------------------------------
# the split route's tensor-core passes in j (the merged up-conv backward)
# and in m's dtaps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["merged", "chain all"])
@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_split_route_passes(cuda, model, route):
    """A bf16 training step on the merged backward route (j at up0-2) and on
    both chains (m's dtaps at the chained DownBlocks). In the step, every
    call of j equals the split pair (``up_dual_conv_dx`` +
    ``up_dual_conv_dtaps``) on that call's own inputs, and every call of
    m's dtaps equals ``phase_conv_dtaps`` at output phase 2 on the
    ``phase_merge``d cotangents, bit for bit; against the same step with
    both patched to their plain versions on the card tensors, the loss
    within 1e-2 of its value (the gradients are not compared: see
    ``test_bf16_step_with_the_mma_grid_fwd``). A trace of the step shows
    ``mma_bwd<MergedUp>`` once a call of j and ``mma_dtaps<SplitGrid>`` once a call
    of m's dtaps, and neither j's SIMT ``merged_bwd<bf16, UpLoad>`` nor any
    bf16 ``dtaps_gemm``."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    routing = dict(merged_bwd="all") if route == "merged" else dict(phase_chain="1")
    calls = []

    def checked_j(x, g, sets, corner_mode, y_groups=None, gs_list=None):
        got = pk.up_dual_conv_bwd(x, g, sets, corner_mode, y_groups, gs_list)
        dx, gsums = pk.up_dual_conv_dx(g, sets, corner_mode, x.dtype, y_groups, gs_list, True)
        dtaps = pk.up_dual_conv_dtaps(x, g, corner_mode, y_groups, gs_list)
        calls.append(("j", got, (dx, *dtaps, *gsums)))
        return got

    def checked_m(phases, g, shapes, corner_mode, act=None, y_groups=None, gs_list=None,
                  emit_gsum=False):
        got = pk.ds2s_dtaps(phases, g, shapes, corner_mode, act, y_groups, gs_list, emit_gsum)
        ref = pk.phase_conv_dtaps(phases, _merge(g), shapes, corner_mode, (2,), act,
                                  None if y_groups is None else _merge(y_groups), gs_list,
                                  emit_gsum)
        calls.append(("m", got, ref))
        return got

    with mock.patch.object(fused, "up_dual_conv_bwd", checked_j), \
            mock.patch.object(fused, "ds2s_dtaps", checked_m):
        loss, launches, grads = _bf16_step(cuda, model, **routing)
    kernel = "up_dual_conv_bwd" if route == "merged" else "ds2s_dtaps"
    n = launches.get(kernel, 0)
    assert n >= 2 and [k for k, _, _ in calls] == ["j" if route == "merged" else "m"] * n
    for _, got, ref in calls:
        _equal_all(got, ref)
    plain = ("up_dual_conv_bwd", "ds2s_dtaps")
    ref_loss, ref_launches, _ = _bf16_step(cuda, model, plain=plain, **routing)
    assert not set(plain) & set(ref_launches)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    names = _dx_kernel_names(lambda: _bf16_step(cuda, model, **routing))
    count = {k: sum(c for name, c in names.items() if all(p in name for p in k))
             for k in (("mma_bwd", "MergedUp"), ("mma_dtaps", "SplitGrid"),
                       ("merged_bwd", "bfloat16", "UpLoad"), ("dtaps_gemm", "bfloat16"))}
    want_j, want_m = (n, 0) if route == "merged" else (0, n)
    assert count[("mma_bwd", "MergedUp")] == want_j, count
    assert count[("mma_dtaps", "SplitGrid")] == want_m, count
    assert count[("merged_bwd", "bfloat16", "UpLoad")] == 0, count
    assert count[("dtaps_gemm", "bfloat16")] == 0, count


def test_split_route_gemms_occupancy(cuda):
    """j's one launch of both GEMMs and each instantiation of m's dtaps GEMM
    (fold or not, NARROW or wide) fit 2 blocks an SM with no local memory
    (no spill)."""
    infos = {"j": build.up_bwd_info()}
    for narrow in (False, True):
        for fold in (False, True):
            infos[f"m narrow={narrow} fold={fold}"] = build.grid_dtaps_info(False, fold, narrow,
                                                                            split=True)
    for key, info in infos.items():
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, (key, info)


# ---------------------------------------------------------------------------
# the split route's tensor-core passes in i (the merged phase-conv backward)
# and in m's dx
# ---------------------------------------------------------------------------

# (level s, C_in, C_out) of i's bit-for-bit cases: levels 1 and 3 at narrow
# widths, b's NARROW tile (C_in 64, as up2's conv01 and down0's stride-2
# conv) and the VAE heads' 256 -> 2x512 at level 2
PHASE_BWD_CASES = {"s1": (1, 12, 20), "s3": (3, 12, 20), "NARROW C_in 64": (4, 64, 64),
                   "heads-like": (2, 256, 512)}


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", list(PHASE_BWD_CASES))
def test_phase_conv_bwd_is_the_split_pair(cuda, case, corner_mode):
    """Kernel i in bf16 is the split route's device code over one folded
    cotangent: a's cotangent pass, dx GEMM and Σg_eff pass, and b's operand
    pass and dtaps GEMM on b's split over the written rows, whose values are
    b's in-kernel fold (both round ``fold_geff`` once). So its outputs equal
    ``phase_conv_dx`` + ``phase_conv_dtaps`` (``emit_gsum``) bit for bit:
    the 4 dphases, d_mul, d_add, each set's dtaps and Σg_eff, in both
    output-phase modes, with 1 and 2 sets, the act and the fold on and off,
    in one launch of the wrapper."""
    s, cin, cout = PHASE_BWD_CASES[case]
    dt = torch.bfloat16
    x, act, sets = _inputs(cuda, dt, s, cin, cout, seed=150 + s)
    phases = _split(x)
    mk, gs = _stats_fold(cuda, dt, phases[0].shape[:-1] + (cout,), 2, seed=s)
    shapes = [(7, cin, cout)] * 2
    for out_phases, n, a, fold in [((0, 1, 2, 3), 1, act, True), ((2,), 2, act, True),
                                   ((0, 1, 2, 3), 2, None, False), ((2,), 1, None, True),
                                   ((2,), 2, act, False)]:
        g = mk(len(out_phases))[:n]
        y = mk(len(out_phases))[:n] if fold else None
        fk = dict(y_groups=y, gs_list=gs[:n]) if fold else {}
        raw = phases if a else None
        build.reset_launches()
        got = pk.phase_conv_bwd(phases, g, y, gs[:n] if fold else None, sets[:n], corner_mode,
                                out_phases, a, fold, dt)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"phase_conv_bwd": 1}
        dphases, dmul, dadd, dx_gsums = pk.phase_conv_dx(g, sets[:n], corner_mode, out_phases,
                                                          cin, dt, a, raw, **fk)
        dtaps, gsums = pk.phase_conv_dtaps(phases, g, shapes[:n], corner_mode, out_phases, a,
                                           **fk, emit_gsum=True)
        _equal_all(got, (dphases, dtaps, gsums, dmul, dadd))
        if fold:  # a's Σg_eff pass over the written rows: the same sums
            _equal_all(got[2], dx_gsums)
        _close_all(got, pk.phase_conv_bwd_plain(phases, g, y, gs[:n] if fold else None, sets[:n],
                                                corner_mode, out_phases, a, fold, dt), dt)


@pytest.mark.parametrize("route", ["merged", "chain all"])
@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_merged_phase_passes(cuda, model, route):
    """A bf16 training step on the merged backward route (i at the UpBlocks'
    conv01, the DownBlocks' stride-2 convs and the VAE's heads) and on both
    chains (m's dx at the chained DownBlocks). In the step, every call of i
    equals ``phase_conv_dx`` + ``phase_conv_dtaps`` on that call's own
    inputs, and every call of m's dx equals ``phase_conv_dx`` at output
    phase 2 on the ``phase_merge``d cotangents, bit for bit. A trace of the
    step shows ``mma_bwd<MergedPhase>`` once a call of i and m's tensor-core dx
    (``mma_conv<SplitGrid, DxEpi>``) once a call of m's dx, and neither the
    SIMT ``merged_bwd<bf16, GridLoad>`` (k runs the tensor cores too) nor a
    bf16 ``dx_gemm`` of m."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    routing = dict(merged_bwd="all") if route == "merged" else dict(phase_chain="1")
    calls = []

    def checked_i(raw, g, y, gs, sets, corner_mode, out_phases, act, with_stats, dt):
        got = pk.phase_conv_bwd(raw, g, y, gs, sets, corner_mode, out_phases, act, with_stats, dt)
        fk = dict(y_groups=y, gs_list=gs) if with_stats else {}
        dx = pk.phase_conv_dx(g, sets, corner_mode, out_phases, raw[0].shape[-1], dt, act,
                              raw if act else None, **fk)
        dtaps, gsums = pk.phase_conv_dtaps(raw, g, [t.shape for t, _ in sets], corner_mode,
                                           out_phases, act, **fk, emit_gsum=True)
        calls.append(("i", got, (dx[0], dtaps, gsums, dx[1], dx[2])))
        return got

    def checked_m(g, sets, corner_mode, cin, dt, act=None, raw=None, y_groups=None,
                  gs_list=None):
        got = pk.ds2s_dx(g, sets, corner_mode, cin, dt, act, raw, y_groups, gs_list)
        ref = pk.phase_conv_dx(_merge(g), sets, corner_mode, (2,), cin, dt, act, raw,
                               None if y_groups is None else _merge(y_groups), gs_list)
        calls.append(("m", got, ref))
        return got

    with mock.patch.object(fused, "phase_conv_bwd", checked_i), \
            mock.patch.object(fused, "ds2s_dx", checked_m):
        _, launches, grads = _bf16_step(cuda, model, **routing)
    kernel = "phase_conv_bwd" if route == "merged" else "ds2s_dx"
    n = launches.get(kernel, 0)
    assert n >= 2 and [k for k, _, _ in calls] == ["i" if route == "merged" else "m"] * n
    for _, got, ref in calls:
        _equal_all(got, ref)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    names = _dx_kernel_names(lambda: _bf16_step(cuda, model, **routing))
    count = {k: sum(c for name, c in names.items() if all(p in name for p in k))
             for k in (("mma_bwd", "MergedPhase"), ("mma_conv", "DxEpi", "SplitGrid"),
                       ("merged_bwd", "bfloat16", "GridLoad"), ("dx_gemm", "bfloat16", "true"))}
    want_i, want_m = (n, 0) if route == "merged" else (0, n)
    assert count[("mma_bwd", "MergedPhase")] == want_i, count
    assert count[("mma_conv", "DxEpi", "SplitGrid")] == want_m, count
    assert count[("merged_bwd", "bfloat16", "GridLoad")] == 0, count
    assert count[("dx_gemm", "bfloat16", "true")] == 0, count


@pytest.mark.parametrize("route", ["merged", "chain all"])
@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_bf16_step_with_the_merged_std_and_split_fwd(cuda, model, route):
    """A bf16 training step on the merged backward route (k at the
    DownBlocks' conv01) and on both chains (m's forward at the chained
    DownBlocks). In the step, every call of k equals ``ico_conv_s2s_dx``
    (with Σg_eff) + ``ico_conv_s2s_dtaps`` on that call's own inputs, and
    every call of m's forward equals ``phase_conv_fwd`` at output phase 2 +
    ``phase_split``, bit for bit. A trace of the step shows
    ``mma_bwd<MergedStd>`` once a call of k and m's tensor-core forward
    (``mma_conv<SplitGrid, SplitFwdEpi>``) once a call of m's forward, and
    neither the SIMT ``merged_bwd<bf16, GridLoad>`` nor a bf16
    ``conv_gemm`` with the split store."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import fused

    routing = dict(merged_bwd="all") if route == "merged" else dict(phase_chain="1")
    calls = []

    def checked_k(x, g, taps, y, gs, corner_mode, act, with_stats, dt, stride=1):
        assert stride == 1
        got = ck.ico_conv_s2s_bwd(x, g, taps, y, gs, corner_mode, act, with_stats, dt)
        y, gs = (y, gs) if with_stats else (None, None)
        dx, dmul, dadd, gsum = ck.ico_conv_s2s_dx(g, taps, corner_mode, dt, act, x, y, gs, True)
        dtaps = ck.ico_conv_s2s_dtaps(x, g, corner_mode, act, y, gs)
        calls.append(("k", got, (dx, dtaps, gsum, dmul, dadd)))
        return got

    def checked_m(phases, sets, corner_mode, act=None, with_stats=False):
        got = pk.ds2s_fwd(phases, sets, corner_mode, act, with_stats)
        ref = pk.phase_conv_fwd(phases, sets, corner_mode, (2,), act, with_stats)
        split = [_split(y) for (y,) in (ref[0] if with_stats else ref)]
        calls.append(("m", got, (split, ref[1]) if with_stats else split))
        return got

    with mock.patch.object(fused, "ico_conv_s2s_bwd", checked_k), \
            mock.patch.object(fused, "ds2s_fwd", checked_m):
        _, launches, grads = _bf16_step(cuda, model, **routing)
    kernel = "ico_conv_s2s_bwd" if route == "merged" else "ds2s_fwd"
    n = launches.get(kernel, 0)
    assert n >= 2 and [k for k, _, _ in calls] == ["k" if route == "merged" else "m"] * n
    for _, got, ref in calls:
        _equal_all(got, ref)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    names = _dx_kernel_names(lambda: _bf16_step(cuda, model, **routing))
    count = {k: sum(c for name, c in names.items() if all(p in name for p in k))
             for k in (("mma_bwd", "MergedStd"), ("mma_conv", "SplitFwdEpi", "SplitGrid"),
                       ("merged_bwd", "bfloat16", "GridLoad"), ("conv_gemm", "bfloat16"))}
    want_k, want_m = (n, 0) if route == "merged" else (0, n)
    assert count[("mma_bwd", "MergedStd")] == want_k, count
    assert count[("mma_conv", "SplitFwdEpi", "SplitGrid")] == want_m, count
    assert count[("merged_bwd", "bfloat16", "GridLoad")] == 0, count
    assert count[("conv_gemm", "bfloat16")] == 0, count


def test_merged_std_and_split_fwd_occupancy(cuda):
    """k's one launch of both GEMMs (f's NARROW dtaps tile or the wide one,
    the act epilogue or not) and m's forward GEMM (the split store, with
    stats or not) fit 2 blocks an SM at 128 registers. k's code is i's
    (``gn::mma_bwd``): no local memory but on the NARROW tile with the act
    epilogue, 16 bytes, as i's (the s=5 sites of k take the wide tile,
    C_in 128-256); m's forward takes none, as b's."""
    infos = {f"k narrow={narrow} act={act}": build.std_bwd_info(narrow, act)
             for narrow in (False, True) for act in (False, True)}
    infos.update({f"m fwd stats={stats}": build.ds2s_fwd_info(stats) for stats in (False, True)})
    for key, info in infos.items():
        spill = 16 if key == "k narrow=True act=True" else 0
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] <= spill, (key, info)
        assert info["registers"] <= 128, (key, info)


def test_merged_phase_gemms_occupancy(cuda):
    """i's one launch of both GEMMs (b's NARROW tile or the wide one, a's act
    epilogue or not) and m's dx GEMM (act or not) fit 2 blocks an SM; all
    but one take no local memory. i's NARROW tile with the act epilogue
    (up2's conv01, down0's stride-2 conv) spills 16 bytes at the 128
    registers that 2 blocks an SM allow, as the card reports it (PERF.md
    §6); more would fail."""
    infos = {f"i narrow={narrow} act={act}": build.phase_bwd_info(narrow, act)
             for narrow in (False, True) for act in (False, True)}
    infos.update({f"m dx act={act}": build.mma_dx_info(False, act, split=True)
                  for act in (False, True)})
    for key, info in infos.items():
        spill = 16 if key == "i narrow=True act=True" else 0
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] <= spill, (key, info)


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
def test_fit_restore_and_next_step_repeat_bit_for_bit(cuda, model, tmp_path):
    """``Trainer.fit`` of the s=4 model in bf16 for 2 epochs (B=4, the last
    batch ragged, checkpoints every epoch), ``restore`` of the newest E file
    into a fresh Trainer: weights, BatchNorm statistics and Adam's state
    bit for bit; one step of each on the same batch (the VAE's generators
    in the same state): metrics bit for bit, as the kernels use no atomics."""
    from geniconet_tpu_torch import Config
    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.train import checkpoint as ckpt
    from geniconet_tpu_torch.train.trainer import Trainer

    s, widths = 4, (8, 16, 16)
    cfg = Config()
    cfg.model.name, cfg.model.subdivisions, cfg.model.widths = model, s, widths
    cfg.model.latent_features, cfg.model.compute_dtype = 8, "bfloat16"
    cfg.train.batch_size, cfg.train.train_epoch, cfg.train.save_epoch_freq = 4, 2, 1
    cfg.log_dir = str(tmp_path)
    variables = bridge.init_variables(s, widths, seed=3, model=model, latent_features=8)
    trn, val = synthetic_dataset(s, 6, seed=0), synthetic_dataset(s, 5, seed=1)
    tr = Trainer(cfg)
    st, history = tr.fit(tr.init_state(variables), Batches(trn, 4, seed=2),
                         Batches(val, 4, shuffle=False))
    assert len(history) == 2 and all(torch.isfinite(torch.tensor(history)))
    ckpt_dir = tmp_path / ("vae" if "vae" in model else "ae") / "savedModel"
    path = ckpt.latest_checkpoint(str(ckpt_dir), model)
    assert path.endswith(f"{model}_E2.ckpt")
    fresh = Trainer(cfg)
    fst, epoch, best = fresh.restore(fresh.init_state(variables), path)
    assert (epoch, best, fst.step, st.step) == (2, min(history), 4, 4)
    sa, sb = tr.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for p, q in zip(tr.model.parameters(), fresh.model.parameters()):
        a, b = st.optimizer.state[p], fst.optimizer.state[q]
        assert all(torch.equal(a[n], b[n]) for n in ("exp_avg", "exp_avg_sq", "step"))
    x, y, wt = next(Batches(trn, 4, seed=9).epoch())
    if fresh.is_vae:
        fresh.generator.set_state(tr.generator.get_state())
    ma, mb = tr.train_step(st, x, y, wt, epoch), fresh.train_step(fst, x, y, wt, epoch)
    for k in ma:
        assert torch.equal(ma[k], mb[k]) if torch.is_tensor(ma[k]) else ma[k] == mb[k], k


def test_point_to_mesh_distance_at_s5_on_the_card(cuda):
    """The evaluation metric on the card (``ops/point_mesh.py``, plain
    PyTorch: no kernel of its own) at s=5, from one bumpy sphere's vertices
    to another: every 16th point against the float64 numpy oracle and the
    CPU's float32, within rtol 1e-4 plus 1e-6 x the extent squared."""
    import numpy as np

    from geniconet_tpu_torch.geometry import ico
    from geniconet_tpu_torch.ops.point_mesh import (point_to_mesh_distance,
                                                    point_to_mesh_distance_numpy)

    s = 5
    rng = np.random.RandomState(0)
    base = ico.get_vertex_coords(s)
    pts, verts = ((base * rng.uniform(0.9, 1.1, (len(base), 1))).astype(np.float32)
                  for _ in range(2))
    faces = ico.get_ico_faces(s)
    got = point_to_mesh_distance(torch.from_numpy(pts).to(cuda), torch.from_numpy(verts).to(cuda),
                                 faces)
    assert got.device.type == "cuda" and got.shape == (len(pts),)
    sub = got.cpu().numpy()[::16]
    extent = float(np.abs(verts).max()) ** 2
    for ref in (point_to_mesh_distance_numpy(pts[::16], verts, faces),
                point_to_mesh_distance(torch.from_numpy(pts[::16]), torch.from_numpy(verts),
                                       faces, chunk=128).numpy()):
        np.testing.assert_allclose(sub, ref, rtol=1e-4, atol=1e-6 * extent)


# ---------------------------------------------------------------------------
# the standard conv at stride 2 (forward, dx, dtaps, merged backward)
# ---------------------------------------------------------------------------

# (level s of the input, C_in, C_out): small grids, a narrow C_in at level 4,
# and the s=5 DownBlocks' stride-2 convs done as standard convs (inputs (32,
# 64) 64 -> 128, (16, 32) 128 -> 256, (8, 16) 256 -> 256)
S2_CASES = {"s1": (1, 12, 20), "s2": (2, 12, 20), "s4": (4, 12, 20), "down0": (5, 64, 128),
            "down1": (4, 128, 256), "down2": (3, 256, 256)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", list(S2_CASES))
def test_std_conv_stride2(cuda, case, corner_mode, dt):
    """The four kernels at stride 2 against their plain versions: the
    forward with the act and the stats, dx with the act adjoint and Σg_eff,
    dtaps in the activation dtype, and the merged backward, the fold on and
    off."""
    s, cin, cout = S2_CASES[case]
    x, act, sets = _inputs(cuda, dt, s, cin, cout, seed=200 + s)
    taps, bias = sets[0]
    for a in (act, None):
        build.reset_launches()
        got = ck.ico_conv_s2s_fwd(x, taps, bias, corner_mode, a, True, stride=2)
        assert dict(build.LAUNCHES) == {"ico_conv_s2s_fwd": 1}
        _close_all(got, ck.ico_conv_s2s_fwd_plain(x, taps, bias, corner_mode, a, True, 2), dt)
    mk, gs = _stats_fold(cuda, dt, x.shape[:2] + (x.shape[2] // 2, x.shape[3] // 2, cout), 1,
                         seed=s)
    for a, fold in [(act, True), (None, False), (act, False), (None, True)]:
        g, y = mk(1)[0][0], mk(1)[0][0]
        fk = dict(y=y, gs=gs[0]) if fold else {}
        args = (g, taps, corner_mode, dt, a, x if a else None)
        _close_all(ck.ico_conv_s2s_dx(*args, **fk, emit_gsum=True, stride=2),
                   ck.ico_conv_s2s_dx_plain(*args, **fk, emit_gsum=True, stride=2), dt)
        got = ck.ico_conv_s2s_dtaps(x, g, corner_mode, a, **fk, stride=2)
        assert got.dtype == dt
        _close(got, ck.ico_conv_s2s_dtaps_plain(x, g, corner_mode, a, **fk, stride=2), dt)
        args = (x, g, taps, fk.get("y"), fk.get("gs"), corner_mode, a, fold, dt)
        _close_all(ck.ico_conv_s2s_bwd(*args, stride=2),
                   ck.ico_conv_s2s_bwd_plain(*args, stride=2), dt)


@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", ["s2", "s4", "down2"])
def test_ico_conv_bwd_is_the_split_pair_at_stride2(cuda, case, corner_mode):
    """Kernel k at stride 2 in bf16 is f's split route at stride 2 bit for
    bit (one launch of the wrapper), as at stride 1; level 2 is a (4, 8)
    input, 160 dx rows a sample, no tap mask."""
    s, cin, cout = S2_CASES[case]
    dt = torch.bfloat16
    x, act, sets = _inputs(cuda, dt, s, cin, cout, seed=210 + s)
    taps = sets[0][0]
    mk, gs = _stats_fold(cuda, dt, x.shape[:2] + (x.shape[2] // 2, x.shape[3] // 2, cout), 1,
                         seed=s)
    for a, fold in [(act, True), (None, False), (act, False), (None, True)]:
        g = mk(1)[0][0]
        y, g_s = (mk(1)[0][0], gs[0]) if fold else (None, None)
        build.reset_launches()
        got = ck.ico_conv_s2s_bwd(x, g, taps, y, g_s, corner_mode, a, fold, dt, stride=2)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"ico_conv_s2s_bwd": 1}
        dx, dmul, dadd, gsum = ck.ico_conv_s2s_dx(g, taps, corner_mode, dt, a, x, y, g_s, True,
                                                  stride=2)
        _equal_all(got, (dx, ck.ico_conv_s2s_dtaps(x, g, corner_mode, a, y, g_s, stride=2), gsum,
                         dmul, dadd))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("corner_mode", MODES)
@pytest.mark.parametrize("case", ["s2", "down0", "down2"])
def test_std_conv_stride2_is_the_phase_conv_at_phase_2(cuda, case, corner_mode, dt):
    """The standard conv at stride 2 is the phase conv at output phase 2 on
    the grid's parity phases (their tables name the same cells,
    tests/test_torch_std_s2.py): the two kernel routes give the same
    output, stats, dx, dtaps and Σg_eff bit for bit (the same GEMM rows in
    the same order; the std dx's extra tap steps read only zeros), and
    d_mul, d_add within the tolerance (their row tiles differ)."""
    s, cin, cout = S2_CASES[case]
    x, act, sets = _inputs(cuda, dt, s, cin, cout, seed=220 + s)
    taps, bias = sets[0]
    phases = tuple(p.contiguous() for p in phase_split(x))
    y, st = ck.ico_conv_s2s_fwd(x, taps, bias, corner_mode, act, True, stride=2)
    ((yp,),), (stp,) = pk.phase_conv_fwd(phases, [(taps, bias)], corner_mode, (2,), act, True)
    _equal_all((y, st), (yp, stp))
    mk, gs = _stats_fold(cuda, dt, yp.shape, 1, seed=s)
    g = mk(1)[0][0]
    dx, dmul, dadd, gsum = ck.ico_conv_s2s_dx(g, taps, corner_mode, dt, act, x, y, gs[0], True,
                                              stride=2)
    dph, dmul_p, dadd_p, (gsum_p,) = pk.phase_conv_dx([[g]], [(taps, None)], corner_mode, (2,),
                                                     cin, dt, act, phases, [[y]], gs)
    _equal_all((dx, gsum), (phase_merge(dph), gsum_p))
    _close_all((dmul, dadd), (dmul_p, dadd_p), dt)
    dtaps = ck.ico_conv_s2s_dtaps(x, g, corner_mode, act, y, gs[0], stride=2)
    (dtaps_p,) = pk.phase_conv_dtaps(phases, [[g]], [tuple(taps.shape)], corner_mode, (2,), act,
                                     [[y]], gs)
    _equal_all((dtaps,), (dtaps_p.to(dt),))
