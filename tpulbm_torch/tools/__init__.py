"""Measurement tools of the port (run as ``python -m tpulbm_torch.tools.<name>``)."""
