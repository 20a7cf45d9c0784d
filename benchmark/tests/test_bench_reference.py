"""The plain reference against the port's plain CPU route, in float32
(CPU). The reference shares no code with the port: these tests are where
the two are held to the same function."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import geometry as geo
from benchmark.reference import loss as L
from benchmark.reference import model as M


@pytest.mark.parametrize("s", [2, 3, 4])
def test_geometry_tables_are_the_ports(s):
    from geniconet_tpu_torch.geometry import ico

    assert np.array_equal(geo.faces(s), ico.get_ico_faces(s))
    assert np.allclose(geo.vertex_coords(s), ico.get_vertex_coords(s))
    for mine, theirs in ((geo.neighbor_table(s), ico.get_neighbor_table(s)),
                         (geo.vertex_face_table(s), ico.get_vertex_face_table(s))):
        assert np.array_equal(mine[1], theirs[1])
        assert np.array_equal(mine[0][mine[1]], theirs[0][theirs[1]])


def test_pad_conv_and_upsample_at_s2():
    from geniconet_tpu_torch.ops.conv import ico_conv_s2s
    from geniconet_tpu_torch.ops.pad import ico_pad
    from geniconet_tpu_torch.ops.upsample import ico_upsample_s2s

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, 8, 6, generator=g)
    taps, bias = torch.randn(7, 6, 5, generator=g), torch.randn(5, generator=g)
    torch.testing.assert_close(M.ico_pad(x, 2), ico_pad(x, 2))
    for stride in (1, 2):
        torch.testing.assert_close(M.hex_conv(x, taps, bias, 2, stride),
                                   ico_conv_s2s(x, taps, bias, 2, stride), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(M.upsample(x, 2), ico_upsample_s2s(x, 2))


def _params(model, widths, latent):
    g = torch.Generator().manual_seed(1)
    out = {}
    for name, shape, kind, fan in M.param_specs(model, widths, latent):
        u = torch.rand(shape, generator=g)
        if kind in ("bn_scale", "bn_var"):
            out[name] = 0.5 + u
        elif kind in ("bn_bias", "bn_mean"):
            out[name] = 0.2 * u - 0.1
        else:
            out[name] = (2 * u - 1) / fan**0.5
    return out


@pytest.mark.parametrize("model", ["ico2ico", "ico2ico_vae"])
@pytest.mark.parametrize("train", [False, True])
def test_models_at_s3(model, train):
    from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE

    s, widths, latent = 3, (8, 16, 32), 24
    p = _params(model, widths, latent)
    vae = model.endswith("_vae")
    net = IcoVAE(s, widths, latent, device="cpu") if vae else IcoAE(s, widths, device="cpu")
    net.load_state_dict(p)
    x = 0.5 * torch.randn(4, *geo.grid_shape(s), 3, generator=torch.Generator().manual_seed(2))
    if vae:
        got, mu, logvar = net(x, train=train, sample=False)
        want, mu_r, logvar_r = M.vae(p, x, s, train)
        torch.testing.assert_close(mu, mu_r, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(logvar, logvar_r, rtol=1e-4, atol=1e-4)
    else:
        got, want = net(x, train=train), M.autoencoder(p, x, s, train)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_losses_at_s3():
    from geniconet_tpu_torch.losses.p2p import LossFactors, p2pkld_loss
    from geniconet_tpu_torch.ops.mesh_math import laplacian_numpy, vertex_normals_numpy

    s = 3
    g = torch.Generator().manual_seed(3)
    v = torch.from_numpy(geo.vertex_coords(s)).float() * (1 + 0.1 * torch.rand(2, 1, 1, generator=g))
    f = geo.faces(s)
    target = torch.stack([torch.from_numpy(np.concatenate(
        [vi.numpy(), vertex_normals_numpy(vi.numpy(), f), laplacian_numpy(vi.numpy(), f)], 1))
        for vi in v]).float()
    out = v[:, :-2].reshape(2, *geo.grid_shape(s), 3) + 0.01 * torch.randn(2, *geo.grid_shape(s), 3,
                                                                            generator=g)
    mu, logvar = torch.randn(2, 5, 2, 8, generator=g), 0.1 * torch.randn(2, 5, 2, 8, generator=g)
    want, _ = p2pkld_loss(out, mu, logvar, target, s, LossFactors.vae(), 1.0)
    factors = {"pos": 0.6, "nor": 0.2, "lap": 0.2}
    got = L.p2p(L.grid_to_vertices(out, s), target, s, factors) + L.kld(mu, logvar)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
