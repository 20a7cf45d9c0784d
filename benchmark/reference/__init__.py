"""The plain float32 PyTorch reference that decides ``correct``. It imports
neither JAX nor either GenIcoNet package, and works out every table it
needs from the geometry itself."""
