"""GenIcoNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``geniconet_tpu`` (JAX/Pallas), which stays beside it as the
reference. Tensors keep the JAX package's layout at every public function:
chart-split, channels-last ``(B, 5, h, w, C)``; hex taps ``(7, C_in, C_out)``;
BatchNorm ``scale/bias/mean/var``.

This package imports ``torch`` and numpy, and nothing of ``jax``, ``flax``
or ``geniconet_tpu``: what it needs of the JAX package's numpy-only modules
it keeps as its own copies (``geometry/ico.py``, ``train/config.py``,
``native/``), which the tests hold equal to the originals. ``geometry`` and
``Config`` are re-exported here. The entry points (``Trainer``,
``AppState``, ``Batches``) run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from geniconet_tpu_torch.geometry import ico as geometry
from geniconet_tpu_torch.train.config import Config

__all__ = ["Config", "geometry"]
