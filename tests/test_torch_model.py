"""The port's IcoAE and weight bridge against the flax IcoAE.

The port follows the JAX package's fused route; the flax reference here is
``IcoAE(use_pallas=False)`` (the XLA route), whose parity with the fused
route tests/test_model_pallas_parity.py pins. float32, eval mode, random
non-trivial BatchNorm statistics; tolerance 1e-4·max|ref|.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geniconet_tpu.nn.models import IcoAE as FlaxIcoAE
from geniconet_tpu_torch import bridge
from geniconet_tpu_torch.nn.models import IcoAE

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WIDTHS = (8, 12, 16)


def _flax_tree(s, seed=0):
    """The flax IcoAE variable tree (structure and shapes from ``init``,
    traced without running), filled with seeded random values."""
    m = FlaxIcoAE(subdivisions=s, widths=WIDTHS)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5 * 2**s, 2 ** (s + 1), 3)))
    r = np.random.RandomState(seed)
    return jax.tree.map(lambda a: r.randn(*a.shape).astype(np.float32), shapes)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bridge_roundtrip_is_exact_and_maps_every_leaf():
    variables = _flax_tree(3)
    sd = bridge.flax_to_state_dict(variables)
    model_sd = IcoAE(3, WIDTHS).state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    back = _leaves(bridge.state_dict_to_flax(sd))
    want = _leaves(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_init_variables_follows_the_flax_tree_and_recipe():
    variables = _flax_tree(3)
    ours = bridge.init_variables(3, WIDTHS, seed=0)
    want = _leaves(variables)
    got = _leaves(ours)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith("['taps']"):
            bound = 1.0 / np.sqrt(7 * got[k].shape[1])
            assert np.abs(got[k]).max() <= bound and np.abs(got[k]).max() > 0.5 * bound
        if k.endswith("['scale']") or k.endswith("['var']"):
            np.testing.assert_array_equal(got[k], 1.0)  # flax's BatchNorm init
        elif "BatchNorm_0" in k:
            np.testing.assert_array_equal(got[k], 0.0)
    again = _leaves(bridge.init_variables(3, WIDTHS, seed=0))
    for k in got:
        np.testing.assert_array_equal(got[k], again[k])


def _port(variables, s, dtype=torch.float32):
    m = IcoAE(s, WIDTHS, dtype=dtype)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    return m.eval()


def _close(got, ref, tol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("s", [3, 4])
def test_encode_decode_match_flax(s):
    variables = bridge.init_variables(s, WIDTHS, seed=s, random_stats=True)
    fm = FlaxIcoAE(subdivisions=s, widths=WIDTHS)
    x = 0.5 * np.random.RandomState(s).randn(2, 5 * 2**s, 2 ** (s + 1), 3).astype(np.float32)
    z_ref = np.asarray(fm.apply(variables, jnp.asarray(x), method="encode"))
    y_ref = np.asarray(fm.apply(variables, jnp.asarray(z_ref), method="decode"))
    m = _port(variables, s)
    with torch.inference_mode():
        z = m.encode(torch.from_numpy(x)).numpy()
        y = m.decode(torch.from_numpy(z_ref.copy())).numpy()
    _close(z, z_ref, 1e-4)
    _close(y, y_ref, 1e-4)
    assert y.dtype == np.float32


def test_bf16_model_tracks_fp32():
    """The bf16 route (activations bf16, float32 sums) stays near float32."""
    s = 3
    variables = bridge.init_variables(s, WIDTHS, seed=1, random_stats=True)
    x = torch.from_numpy(0.5 * np.random.RandomState(1).randn(2, 40, 16, 3).astype(np.float32))
    with torch.inference_mode():
        y32 = _port(variables, s)(x).numpy()
        y16 = _port(variables, s, torch.bfloat16)(x)
    assert y16.dtype == torch.float32
    _close(y16.numpy(), y32, 5e-2)


def test_port_imports_no_jax():
    """Importing the port (server and trainer included) pulls in neither jax nor flax."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import geniconet_tpu_torch, geniconet_tpu_torch.app.server, geniconet_tpu_torch.bridge\n"
        "import geniconet_tpu_torch.ops.kernels.build, geniconet_tpu_torch.ops.kernels.fused\n"
        "import geniconet_tpu_torch.train.trainer, geniconet_tpu_torch.data.pipeline\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("s", [2, 3])
def test_ico_identity_is_the_flax_identity(s):
    """IcoIdentity: the output equals the input, W's gradient is zero, and
    the flax module's W (shaped from its input grid) bridges into the
    port's (shaped from ``subdivisions``) and back unchanged."""
    from geniconet_tpu.nn.models import IcoIdentity as FlaxIcoIdentity
    from geniconet_tpu_torch.nn.models import IcoIdentity

    H, W = 5 * 2**s, 2 ** (s + 1)
    x = np.random.RandomState(s).randn(2, H, W, 3).astype(np.float32)
    fm = FlaxIcoIdentity(subdivisions=s)
    variables = jax.tree.map(np.asarray, fm.init({"params": jax.random.key(s)}, jnp.asarray(x)))
    m = IcoIdentity(s)
    assert tuple(m.W.shape) == variables["params"]["W"].shape == (1, H, W, 3)
    m.load_state_dict(bridge.flax_to_state_dict(variables))
    np.testing.assert_array_equal(m.W.detach().numpy(), variables["params"]["W"])
    back = bridge.state_dict_to_flax(m.state_dict())
    np.testing.assert_array_equal(back["params"]["W"], variables["params"]["W"])
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(fm.apply(variables, x)))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y**2).sum().backward()
    assert m.W.grad is not None and not m.W.grad.any()
    np.testing.assert_array_equal(xt.grad.numpy(), 2 * x)
