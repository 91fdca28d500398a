"""Core identifiers the port's codec reads (its own copies)."""
