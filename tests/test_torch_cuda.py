"""The CUDA kernels on the card, against their plain PyTorch versions.

This file imports no JAX, so it runs on the card's machine (which has no
JAX) with the JAX-only conftest left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips. Tolerances: float32 1e-4·max|ref|
(only the order of the float32 sums differs), bfloat16 2e-2·max|ref| (the
float32 sums round to bf16 at different points).
"""

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


def _head_mse_inputs(device, dt, s, C, seed):
    g = torch.Generator().manual_seed(seed)
    h, w = 2**s, 2 ** (s + 1)
    b0 = [torch.randn(3, 5, h, w, C, generator=g).to(device, dt) for _ in range(8)]
    aff = [t.to(device) for t in (torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g),
                                  torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g))]
    W = (torch.randn(C, 3, generator=g) * C**-0.5).to(device, dt)
    bias = (0.1 * torch.randn(3, generator=g)).to(device, dt)
    tpack = torch.rand(3, 5, h, w, 12, generator=g).mul(2).sub(1).to(device)
    tpoles = torch.rand(3, 6, generator=g).mul(2).sub(1).to(device)
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
    ``phase_conv_dtaps`` on the ``phase_merge``d cotangents, bit for bit;
    and m is within the tolerance of its plain versions."""
    x, act, sets = _inputs(cuda, dt, s, 12, 20, seed=130 + s)
    phases = _split(x)
    for a in (act, None):
        got = pk.ds2s_fwd(phases, sets, corner_mode, a, with_stats=True)
        ref_sets, ref_stats = pk.phase_conv_fwd(phases, sets, corner_mode, (2,), a, True)
        _equal_all(got, ([_split(y) for (y,) in ref_sets], ref_stats))
        _close_all(got, pk.ds2s_fwd_plain(phases, sets, corner_mode, a, True), dt)
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
        _equal_all(got, pk.phase_conv_dx(_merge(g), sets, corner_mode, (2,), 12, dt, a, raw,
                                         **fkm))
        _close_all(got, pk.ds2s_dx_plain(g, sets, corner_mode, 12, dt, a, raw, **fk), dt)
        got = pk.ds2s_dtaps(phases, g, shapes, corner_mode, a, **fk, emit_gsum=True)
        _equal_all(got, pk.phase_conv_dtaps(phases, _merge(g), shapes, corner_mode, (2,), a,
                                            **fkm, emit_gsum=True))
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
