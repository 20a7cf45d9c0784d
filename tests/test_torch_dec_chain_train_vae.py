"""The VAE's ``Trainer`` on both halves' phase chain (``phase_chain="1"``:
kernels m and n) against the JAX ``Trainer`` on its chain, on the CPU: two
steps, eps fixed on both sides; the check and its tolerances are
``tests/test_torch_dec_chain_train.py``'s, which holds the AE's cases. A
file of its own so that ``--dist loadfile`` spreads the interpret-mode time
(about 75 s in one process).
"""

from test_torch_dec_chain_train import dec_chain_trainer_matches_jax_trainer, env  # noqa: F401


def test_vae_dec_chain_trainer_matches_jax_trainer_on_its_chain(env):  # noqa: F811
    dec_chain_trainer_matches_jax_trainer(env, "ico2ico_vae", "1", None)
