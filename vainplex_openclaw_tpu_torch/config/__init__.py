"""Config helpers the port keeps its own copy of."""
