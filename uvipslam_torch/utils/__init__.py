"""Counterpart of uvipslam_tpu.utils (host utilities)."""
