"""Training: the train step (train_step.py) with AdamW (optim.py) and
AutoClip (autoclip.py), the loop (trainer.py) and the checkpoints
(checkpoints.py)."""
