"""Counterpart of uvipslam_tpu.solver."""
