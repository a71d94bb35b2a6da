"""Command-line entry points of the port (cli/serve.serve_shard so far)."""
