"""Host utilities for the port: metrics, evaluation and device checks."""
