"""Operators: TF-exact conv, pool and resize, and the E-step."""
