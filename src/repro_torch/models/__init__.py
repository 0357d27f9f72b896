"""Dense decoder-only model family in PyTorch."""
