"""Command-line entry points of the port: the trainer (``cli.main``)."""
