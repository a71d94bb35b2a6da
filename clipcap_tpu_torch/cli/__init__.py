"""Command-line entry points of the port: folder inference (cli/infer.py),
the batch caption server (cli/serve.py) and their loaders (cli/loading.py)."""
