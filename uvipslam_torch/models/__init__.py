"""Counterpart of uvipslam_tpu.models."""
