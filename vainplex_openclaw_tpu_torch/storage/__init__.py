"""State the port keeps across requests: atomic JSON files and debounced
saves, the group-commit workspace journal, the lifecycle manager that
hibernates workspaces and pages weight versions, and the workspace
layout."""
