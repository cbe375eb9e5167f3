"""Scalar event logging: terminal + metrics.json lines.

The port's own copy of catseg_tpu/utils/events.py (no JAX in it): the
functional replacement for detectron2's EventStorage/metrics.json, one JSON
object per logged step appended to OUTPUT_DIR/metrics.json, plus a human
line to stdout/log.txt.  In data-parallel training only rank 0 writes:
the others pass no directory and ``echo=False``.
"""

from __future__ import annotations

import json
import os
import time


class EventWriter:
    def __init__(self, output_dir: str | None = None, echo: bool = True):
        self.output_dir = output_dir
        self.echo = echo
        self._metrics_f = None
        self._log_f = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._metrics_f = open(os.path.join(output_dir, "metrics.json"), "a")
            self._log_f = open(os.path.join(output_dir, "log.txt"), "a")
        self._t0 = time.time()

    def write(self, step: int, **scalars) -> None:
        rec = {"iteration": step, "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            # scalars only: eval_fn dicts can carry per-class ndarrays
            # ('IoU'/'ACC') or a confusion matrix — float() on those raises,
            # which must not abort a multi-hour run at a periodic eval
            if isinstance(v, (int, float)):
                rec[k] = float(v)
            elif hasattr(v, "item"):
                if getattr(v, "size", 1) == 1:
                    rec[k] = float(v)
                # else: non-scalar array — skip, not crash
            elif not hasattr(v, "shape"):
                rec[k] = v
        line = "  ".join(f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}" for k, v in rec.items())
        if self.echo:
            print(line)
        if self._log_f:
            self._log_f.write(line + "\n")
            self._log_f.flush()
        if self._metrics_f:
            self._metrics_f.write(json.dumps(rec) + "\n")
            self._metrics_f.flush()

    def close(self) -> None:
        for f in (self._metrics_f, self._log_f):
            if f:
                f.close()
