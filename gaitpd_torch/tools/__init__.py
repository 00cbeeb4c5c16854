"""Measurement tools of the port, each run as ``python -m gaitpd_torch.tools.<name>``."""
