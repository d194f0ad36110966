"""Gradient helpers and canonically associated reductions."""
