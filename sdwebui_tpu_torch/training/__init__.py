"""Textual-inversion and hypernetwork training, their dataset and the
dataset preprocessing pass."""
