"""Kernels written by hand for the card, each beside its plain version."""
