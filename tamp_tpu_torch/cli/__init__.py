"""Command-line interface of tamp_tpu_torch."""
