"""Host-side graph layer: dot-bracket parsing and window features."""
