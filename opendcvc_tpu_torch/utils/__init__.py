"""Helpers: the JAX weight bridge."""
