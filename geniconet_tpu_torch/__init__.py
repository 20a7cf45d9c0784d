"""GenIcoNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``geniconet_tpu`` (JAX/Pallas), which stays beside it as the
reference. Tensors keep the JAX package's layout at every public function:
chart-split, channels-last ``(B, 5, h, w, C)``; hex taps ``(7, C_in, C_out)``;
BatchNorm ``scale/bias/mean/var``.

This package imports ``torch`` and never ``jax`` or ``flax``. It reuses the
numpy-only modules of the JAX package (``geometry.ico``, ``data.offio``,
``train.config``, ``native``); ``geometry`` and ``Config`` are re-exported
here so that callers of the port need import nothing else.
"""

from geniconet_tpu.geometry import ico as geometry
from geniconet_tpu.train.config import Config

__all__ = ["Config", "geometry"]
