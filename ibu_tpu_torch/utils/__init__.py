"""Small helpers: device selection."""
