"""Entry points of the port: ``serve`` (the serving CLI)."""
