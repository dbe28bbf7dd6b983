"""Ports of the JAX package's benchmarks, run on the card."""
