"""Command-line tools of the port (twins of the repository's tools/)."""
