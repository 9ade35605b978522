"""State the port keeps across requests: the LRU manager that pages
weight versions, and atomic JSON files."""
