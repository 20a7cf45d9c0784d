"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper takes a CUDA tensor to its kernel (or raises) and a CPU tensor
to the kernel's plain PyTorch version, which sits beside it in the same
module. ``build.LAUNCHES`` counts the kernel launches per wrapper.
"""
