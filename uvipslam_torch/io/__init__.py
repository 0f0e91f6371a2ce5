"""Counterpart of uvipslam_tpu.io."""
