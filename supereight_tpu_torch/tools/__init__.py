"""Command-line tools of the port (``python -m supereight_tpu_torch.tools.<name>``)."""
