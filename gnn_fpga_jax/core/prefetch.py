"""Host→device prefetching input pipeline.

The reference's generator hands each batch to the training step
synchronously (`trainSegmentClassifier.py:97-111` + per-batch
``np_to_torch(...).cuda()`` copies at `:38-44`), so the accelerator idles
while the host builds and ships the next batch.  Host-side graph padding
and the host-to-device copy are both non-trivial, so we overlap both:

- a background thread pulls batches from the (CPU, numpy) generator and
  calls ``jax.device_put`` — transfers are async in JAX, so the copy
  overlaps the in-flight training step;
- a small bounded queue (default depth 2: one in transfer, one ready)
  applies back-pressure so host memory stays bounded.

This is the replacement for the reference's mp.Pool-fed epoch loop (SURVEY §2.3 "Grain/tf.data parallel host input pipeline"),
without adding a dependency.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import jax


class PrefetchIterator:
    """Wrap a batch iterator with background device_put prefetching.

    Args:
      it: source iterator yielding pytrees of host arrays.
      size: queue depth (number of batches in flight; >= 1).
      device: target device or sharding for ``jax.device_put`` (None =
        default device).
      n_batches: stop after this many batches (None = until ``it`` ends).

    Iterating yields device-resident pytrees.  The worker thread is a
    daemon; call :meth:`close` (or exhaust the iterator) to stop it
    eagerly.  Exceptions in the source generator propagate to the
    consumer on the next ``__next__``.
    """

    _DONE = object()

    def __init__(self, it: Iterator[Any], size: int = 2,
                 device=None, n_batches: Optional[int] = None):
        if size < 1:
            raise ValueError("prefetch size must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                n = 0
                for batch in it:
                    if self._stop.is_set():
                        return
                    if n_batches is not None and n >= n_batches:
                        break
                    dev = (jax.device_put(batch, device) if device is not None
                           else jax.device_put(batch))
                    # block here (bounded queue) — back-pressure
                    while not self._stop.is_set():
                        try:
                            self._q.put(dev, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    n += 1
            except BaseException as e:  # surfaced to the consumer
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def prefetch_to_device(generator: Iterator[Any], size: int = 2,
                       device=None,
                       n_batches: Optional[int] = None) -> PrefetchIterator:
    """Convenience wrapper: ``for batch in prefetch_to_device(gen): ...``"""
    return PrefetchIterator(generator, size=size, device=device,
                            n_batches=n_batches)
