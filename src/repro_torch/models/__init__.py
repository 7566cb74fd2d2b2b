"""Functional PyTorch models over nested-dict parameters."""
