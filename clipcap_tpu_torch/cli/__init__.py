"""Command-line entry points of the port: folder inference (cli/infer.py),
checkpoint evaluation (cli/evaluate.py), the batch caption server
(cli/serve.py) and their loaders (cli/loading.py)."""
