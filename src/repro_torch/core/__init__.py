"""Sparsifier config, selectors, the compact runtime and the trainer's
sparsify-aggregate round (``repro.core``'s counterparts)."""
