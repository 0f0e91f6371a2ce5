"""Counterpart of uvipslam_tpu.mapstate."""
