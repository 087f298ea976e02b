"""The plain reference codecs: plain PyTorch, float32, independent of
the measured package."""
