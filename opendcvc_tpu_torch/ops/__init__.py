"""Tensor ops (`fused`) and the hand-written kernels (`lane_rans`)."""
