"""Data parallelism over ``torch.distributed`` (``dist.py``)."""
