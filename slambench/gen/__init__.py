"""Scan generators, one module per scene kind, found by the name a
configuration gives under ``generator``: ``generate(scene, n_sets,
seed, device)``."""
