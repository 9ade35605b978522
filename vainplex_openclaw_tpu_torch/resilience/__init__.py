"""Admission control for the serve queue."""
