"""Measuring tools of the port, run as ``python -m feature_intertwiner_tpu_torch.tools.<name>``."""
