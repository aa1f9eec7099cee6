"""The benchmark of ``supereight_tpu_torch`` (see README.md)."""
