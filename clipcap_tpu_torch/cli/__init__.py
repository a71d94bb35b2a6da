"""Command-line entry points of the port: folder inference (cli/infer.py),
checkpoint evaluation (cli/evaluate.py), the batch caption server
(cli/serve.py), training (cli/train.py), the Gen-B apps over the synthesis
engine (cli/synthesis.py): single-image captioning (cli/caption_me.py), the
COCO sampling sweep (cli/sweep.py) and human-eval preparation
(cli/human_eval.py), and their loaders (cli/loading.py)."""
