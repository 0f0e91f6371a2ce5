"""Counterpart of uvipslam_tpu.loop."""
