"""Parallel, prefetched input pipeline.

Counterpart of `garment4d_tpu/data/pipeline.py` (the reference feeds the
GPU from `DataLoader(num_workers=8, pin_memory=True)`,
`train_temporal.py:85-107`): a thread pool over the per-item disk reads
plus a one-batch-deep background prefetch, so host-side work overlaps
device compute. `Cloth3dDataset.raw_item` is file reads, unpickling and
numpy on small arrays, much of it under the GIL; how far the threads
spread it is measured by `chip_smoke.py`'s entry-point phase (the data
path and the loader alone at 0, 1 and 8 workers). The threads touch no
CUDA state: `data/cloth3d.finalize_batch`, which runs on the device, stays
on the caller's thread, and CUDA launches are asynchronous, so the device
stays busy while the next batch's files load.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence


class ParallelItemLoader:
    """Maps `load(index)` over index batches with a thread pool, keeping
    batch order and overlapping the NEXT batches' reads with the consumer.

    `num_workers=0` degrades to fully synchronous reads (reference
    `DataLoader(num_workers=0)` semantics).
    """

    def __init__(self, load: Callable[[int], dict], num_workers: int = 8,
                 prefetch_batches: int = 2):
        self._load = load
        self._num_workers = int(num_workers)
        self._prefetch = max(1, int(prefetch_batches))
        self._pool: Optional[ThreadPoolExecutor] = None
        if self._num_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers,
                thread_name_prefix="g4d-loader")

    def map_batches(self, index_batches: Sequence[Sequence[int]]
                    ) -> Iterator[list]:
        """Yield, per index batch, the list of loaded items (in order)."""
        if self._pool is None:
            for idxs in index_batches:
                yield [self._load(j) for j in idxs]
            return
        pending = []
        batches = iter(index_batches)

        def schedule():
            try:
                idxs = next(batches)
            except StopIteration:
                return False
            pending.append([self._pool.submit(self._load, j) for j in idxs])
            return True

        for _ in range(self._prefetch + 1):
            if not schedule():
                break
        while pending:
            futures = pending.pop(0)
            schedule()
            yield [f.result() for f in futures]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


def prefetch_iterator(make_iter: Callable[[], Iterable], depth: int = 1
                      ) -> Iterator:
    """Run `make_iter()` on a background thread, buffering up to `depth`
    finished elements. Exceptions re-raise at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    _END = object()

    def worker():
        try:
            for item in make_iter():
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True,
                         name="g4d-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
