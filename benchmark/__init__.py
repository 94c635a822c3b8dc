"""The benchmark of ray_tpu_torch (see README.md)."""
