"""Command-line tools of the port (measurement on the card)."""
