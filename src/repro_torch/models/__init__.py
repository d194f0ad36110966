"""Functional models over nested-dict params in the JAX layout."""
