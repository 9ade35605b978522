"""Stdlib-only utilities the port keeps its own copy of."""
