"""The port's benchmark: see ``run.py`` and ``spec.py``."""
