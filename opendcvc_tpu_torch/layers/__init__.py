"""NN building blocks."""
