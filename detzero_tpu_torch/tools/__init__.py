"""Command-line entry points; run them with `python -m`."""
