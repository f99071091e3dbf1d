"""Plain PyTorch references, independent of both packages under test."""
