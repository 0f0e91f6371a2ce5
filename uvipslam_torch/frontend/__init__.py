"""Counterpart of uvipslam_tpu.frontend."""
