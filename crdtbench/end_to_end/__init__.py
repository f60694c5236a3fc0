"""The readers of the window's timings, one an end-to-end metric."""
