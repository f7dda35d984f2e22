"""The benchmark of ganspace_tpu_torch: see README.md."""
