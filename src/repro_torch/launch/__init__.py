"""Device meshes over the batch axes of sweeps and stores (PyTorch)."""
