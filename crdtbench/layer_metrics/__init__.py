"""The readers of the traced window, one a per-layer metric."""
