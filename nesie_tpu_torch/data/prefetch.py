"""Background batch prefetching (a copy of ``nesie_tpu/data/prefetch.py``):
overlaps host-side scene loading, sampling and the copy to the device with
the device step (the reference gets this from torch DataLoader workers;
here a bounded thread queue suffices since augmentation runs on the
device)."""
from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Wrap a batch-producing generator in a background thread.

    Usage:
        pf = Prefetcher(batch_iter(), depth=2)
        for batch in pf: ...
    """

    _DONE = object()

    def __init__(self, iterator, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.err = None

        def worker():
            try:
                for item in iterator:
                    self.q.put(item)
            except BaseException as e:  # surface worker errors to the consumer
                self.err = e
            finally:
                self.q.put(self._DONE)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.err is not None:
                    raise self.err
                return
            yield item
