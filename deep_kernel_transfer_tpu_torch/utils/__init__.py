"""Helpers around the port: weights carried across from the JAX package."""
