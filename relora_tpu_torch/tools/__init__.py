"""Command-line tools over the port's telemetry files (no torch imported)."""
