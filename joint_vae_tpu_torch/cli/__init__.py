"""Command-line entry points of the port (this slice: serve)."""
