"""Runnable scripts of the port (``python -m muax_tpu_torch.examples.<name>``)."""
