"""Scale-out over independent SLAM streams (batched replay)."""
