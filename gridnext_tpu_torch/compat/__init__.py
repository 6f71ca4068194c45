"""Bridges from the JAX package's checkpoints and model directories."""
