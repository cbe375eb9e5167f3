"""Pipelined asynchronous prediction (catseg_tpu/infer/async_predictor.py).

The reference demo's AsyncPredictor runs one worker process per GPU with
task and result queues (demo/predictor.py:132-219).  Here one worker thread
prepares each image and enqueues its sliding-window forward on the card;
CUDA launches are asynchronous, so the host's work on the next image
overlaps the device's on this one.  Same put / get API as catseg_tpu's.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .pipeline import Predictor


class _WorkerError:
    __slots__ = ("exc",)

    def __init__(self, exc: Exception):
        self.exc = exc


class AsyncPredictor:
    def __init__(self, predictor: Predictor, depth: int = 4):
        self.predictor = predictor
        self._tasks: queue.Queue = queue.Queue(maxsize=depth)
        self._results: queue.Queue = queue.Queue()
        self._n_submitted = 0
        self._n_collected = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            idx, image = self._tasks.get()
            if image is None:
                break
            # an exception (an odd input, a device error) goes to the consumer,
            # whose get() raises it, instead of ending the thread and leaving
            # get() blocked; the worker goes on with the next image
            try:
                probs = self.predictor.probs_sliding(image)
            except Exception as e:  # noqa: BLE001 -- forwarded to get(), not swallowed
                self._results.put((idx, _WorkerError(e)))
                continue
            self._results.put((idx, probs))

    def put(self, image: np.ndarray) -> int:
        """Queue one (H, W, 3) image; returns its index.  Blocks while
        ``depth`` images wait."""
        idx = self._n_submitted
        self._tasks.put((idx, image))
        self._n_submitted += 1
        return idx

    def get(self):
        """(index, (640, 640, T) probs on the predictor's device), in
        submission order (one worker); raises the worker's exception for an
        image whose prediction failed."""
        self._n_collected += 1
        idx, item = self._results.get()
        if isinstance(item, _WorkerError):
            raise item.exc
        return idx, item

    def __len__(self):
        return self._n_submitted - self._n_collected

    def shutdown(self):
        """Stop the worker after the images already queued."""
        self._tasks.put((-1, None))
        self._thread.join()
