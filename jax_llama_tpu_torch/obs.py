"""Structured logging (``StructuredLogger``, copied from
``jax_llama_tpu/obs.py``).  The rest of the observability layer (request
timelines, dispatch spans, histograms, SLO accounting, the log ring the
HTTP server's debug endpoints read) is ROADMAP A7."""

from __future__ import annotations

import json
import time
from typing import Any, Dict


class StructuredLogger:
    """One formatter for every operational log line, printed to stdout.

    ``json_mode=False`` (default) renders ``event k=v ...`` text;
    ``json_mode=True`` (run.py ``--log-json``) renders one JSON object per
    line with a stable ``event`` field."""

    def __init__(self, json_mode: bool = False):
        self.json_mode = bool(json_mode)

    def log(self, event: str, message: str = "", **fields) -> None:
        if self.json_mode:
            rec: Dict[str, Any] = {
                "ts": round(time.time(), 3), "event": event,
            }
            if message:
                rec["message"] = message
            rec.update({k: v for k, v in fields.items() if v is not None})
            line = json.dumps(rec, default=str)
        else:
            parts = [event]
            if message:
                parts.append(message)
            parts.extend(
                f"{k}={v}" for k, v in fields.items() if v is not None
            )
            line = " ".join(parts)
        print(line, flush=True)
