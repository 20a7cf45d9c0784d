"""Model summaries: the parameter count.

Port of ``count_params`` of ``geniconet_tpu/train/summary.py``. The flax
``tabulate`` summary and the graph's ``.dot`` drawing are not ported yet.
"""

from __future__ import annotations

import math

__all__ = ["count_params"]


def count_params(params) -> int:
    """Elements in a tree (nested dicts) of arrays or tensors, such as the
    ``"params"`` tree of ``Trainer.variables()``."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return math.prod(params.shape)
