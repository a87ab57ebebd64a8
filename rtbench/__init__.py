"""The benchmark of ``clraytracer_tpu_torch`` on the card (see README.md)."""
