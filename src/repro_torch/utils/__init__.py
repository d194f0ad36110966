"""Flat-vector pytree helpers and device resolution."""
