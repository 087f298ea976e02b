"""Codec models: DMCI (intra) and DMC (P-frame), DCVC-RT."""
