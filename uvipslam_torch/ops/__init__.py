"""Counterpart of uvipslam_tpu.ops."""
