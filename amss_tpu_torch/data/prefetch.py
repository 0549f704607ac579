"""Host-to-device prefetch (``amss_tpu/data/prefetch.py``).

A background thread draws host batches and puts them on the device while the
device runs the step before: ``make_batch(step)`` draws, ``put_batch(host)``
copies (the trainer's puts the int16 wire format into pinned memory and copies
it with ``non_blocking=True``).  An exception in the worker is raised again in
the consumer, and so is a stall: no batch within ``stall_timeout`` seconds.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Iterate ``(step, device batch)`` with a lookahead of ``depth``."""

    def __init__(self, make_batch, put_batch, start_step: int, end_step: int,
                 depth: int = 2, stall_timeout: float = 900.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._closed = False
        self._stall_timeout = stall_timeout

        def worker():
            try:
                for step in range(start_step, end_step):
                    if self._closed:
                        return
                    item = (step, put_batch(make_batch(step)))
                    while not self._closed:  # a bounded put that close() can abort
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
            except BaseException as e:  # raised again by __next__
                self._err = e
            finally:
                # the end marker must not be dropped, or the consumer would
                # wait on get() forever
                while not self._closed:
                    try:
                        self._q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        pass

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the worker early (early stopping): flag, drain, join."""
        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._stall_timeout)
        except queue.Empty:
            raise RuntimeError(
                f"prefetch worker produced nothing for {self._stall_timeout:g} s"
            ) from None
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
