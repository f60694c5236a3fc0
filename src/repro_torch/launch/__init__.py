"""Device meshes over the batch axes of sweeps and stores (``mesh``), and
the model side's batched server (``serve``) and training driver
(``train``), in PyTorch."""
