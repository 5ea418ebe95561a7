"""Background-thread batch prefetching.

The reference hides host latency behind torch DataLoader worker processes
(``num_workers=5``, ``src/config/data.yaml:7``).  Here a single background thread
prepares upcoming batches (image decode + tokenize + collate happen off the
dispatch path) while the TPU executes the current step — the right shape for a
jit-dispatch pipeline, where the host only needs to stay one batch ahead.
``workers > 1`` additionally fans the transform (collate) out over a thread
pool with order preserved — the analog of DataLoader worker parallelism for
transforms whose heavy parts (PIL decode, the native C++ resize, numpy) release
the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional


class PrefetchIterator:
    """Wrap any iterable; items are produced by a daemon thread into a queue."""

    _SENTINEL = object()

    def __init__(
        self,
        iterable: Iterable,
        depth: int = 2,
        transform: Optional[Callable] = None,
        workers: int = 1,
    ):
        self.iterable = iterable
        self.depth = depth
        self.transform = transform
        self.workers = max(1, workers)

    def __iter__(self) -> Iterator[Any]:
        if self.workers > 1 and self.transform is not None:
            yield from self._iter_pool()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        error: list = []

        def worker():
            try:
                for item in self.iterable:
                    if self.transform is not None:
                        item = self.transform(item)
                    q.put(item)
            except BaseException as e:  # propagate into the consumer
                error.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if error:
                    raise error[0]
                return
            yield item

    def _iter_pool(self) -> Iterator[Any]:
        """Ordered concurrent map: a feeder thread submits transform futures
        into a bounded queue; the consumer drains them in submission order."""
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.depth + self.workers)
        error: list = []
        with ThreadPoolExecutor(max_workers=self.workers) as pool:

            def feeder():
                try:
                    for item in self.iterable:
                        q.put(pool.submit(self.transform, item))
                except BaseException as e:
                    error.append(e)
                finally:
                    q.put(self._SENTINEL)

            t = threading.Thread(target=feeder, daemon=True)
            t.start()
            while True:
                fut = q.get()
                if fut is self._SENTINEL:
                    if error:
                        raise error[0]
                    return
                yield fut.result()  # re-raises transform errors in order

    def __len__(self) -> int:
        return len(self.iterable)  # type: ignore[arg-type]


def prefetch(
    iterable: Iterable,
    depth: int = 2,
    transform: Optional[Callable] = None,
    workers: int = 1,
):
    return PrefetchIterator(iterable, depth=depth, transform=transform, workers=workers)
