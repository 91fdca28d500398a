"""Core identifiers and the op/change model (the port's own copies)."""
