"""Entropy models, CDF tables and the device lane rANS container."""
