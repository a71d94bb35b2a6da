"""Metric logging: JSONL always, wandb when available (the port's own copy
of clipcap_tpu/utils/logging.py).

The reference logs through Lightning's WandbLogger (train.py:256-260,
model.py:211-214). wandb isn't a hard dependency here: metrics always go
to stdout + a JSONL file; if wandb is importable and enabled, they mirror
there (incl. the validation caption table, see eval/validator.py).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional


def _try_wandb(project: Optional[str], name: Optional[str]):
    try:
        import wandb  # type: ignore

        wandb.init(project=project, name=name)
        return wandb
    except Exception:
        return None


class MetricLogger:
    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        use_wandb: bool = False,
        wandb_project: str = "clipcap-tpu",
        wandb_name: Optional[str] = None,
        echo: bool = True,
    ):
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.echo = echo
        self.wandb = _try_wandb(wandb_project, wandb_name) if use_wandb else None
        self._t0 = time.time()

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"t": round(time.time() - self._t0, 3), **metrics}
        if step is not None:
            rec["step"] = step
        if self.echo:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
            )
            print(parts, file=sys.stderr)
        if self.jsonl:
            self.jsonl.write(json.dumps(rec, default=str) + "\n")
            self.jsonl.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)

    def log_table(self, key: str, columns, rows):
        """Validation caption table (reference model.py:102-130)."""
        if self.wandb:
            self.wandb.log({key: self.wandb.Table(columns=list(columns), data=rows)})
        elif self.jsonl:
            self.jsonl.write(
                json.dumps({"table": key, "columns": list(columns), "rows": rows},
                           default=str) + "\n"
            )
            self.jsonl.flush()

    def close(self):
        if self.jsonl:
            self.jsonl.close()
