"""Counterpart of uvipslam_tpu.core."""
