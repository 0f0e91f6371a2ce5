"""Counterpart of uvipslam_tpu.viz (host-side drawing)."""
