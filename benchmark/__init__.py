"""The benchmark of ``geniconet_tpu_torch`` on one NVIDIA H100: see ``run.py``."""
