"""Counterpart of uvipslam_tpu.vio."""
