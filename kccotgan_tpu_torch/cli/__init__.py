"""Command-line entry points of the port: the trainer (``cli.main``), the
sampler (``cli.sample``) and the serving export (``cli.export``)."""
