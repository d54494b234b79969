"""File-backed structured metrics logger: the JAX package's stream.

- ``metrics.jsonl``: one JSON object per log call,
  {"step": int, "split": "train|val|test", "time": s, "epoch": int,
  **metrics};
- a console line for the same event.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, outdir: str, filename: str = "metrics.jsonl",
                 echo: bool = True):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, filename)
        self.echo = echo
        self._t0 = time.time()
        self._fh = open(self.path, "a", buffering=1)

    def log(self, metrics: Dict[str, float], step: int,
            epoch: Optional[int] = None, split: str = "train") -> None:
        rec = {"step": int(step), "split": split,
               "time": round(time.time() - self._t0, 2)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            body = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("step", "split", "time", "epoch"))
            print(f"[{split} step={step}"
                  + (f" epoch={rec['epoch']}" if "epoch" in rec else "")
                  + f"] {body}")

    def close(self) -> None:
        self._fh.close()
