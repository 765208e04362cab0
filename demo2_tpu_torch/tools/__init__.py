"""Measurement tools of the port (demo2_tpu's tools/ directory)."""
