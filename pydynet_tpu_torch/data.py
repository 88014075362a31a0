"""Data pipeline: the port's own copy of ``pydynet_tpu/data.py``, which is
NumPy only.

A PyTorch-shaped surface, ``Dataset`` / ``Sampler`` / ``SequentialSampler``
/ ``RandomSampler`` / ``BatchSampler`` / ``DataLoader`` / ``data_loader``,
with the JAX package's behaviour: index batches are plain Python int lists,
a batch is fetched with ONE fancy index into the dataset, and the shuffle
order comes from NumPy's global stream, so under one ``np.random.seed`` the
two packages yield the same batches in the same order. Batches are NumPy
arrays; the caller moves them to its device. ``DataLoader(prefetch=n)``
assembles batches on a background thread (NumPy fancy indexing releases the
GIL) so host batch assembly overlaps the device's step.
"""
import itertools
import queue
import threading

import numpy as np


class Dataset:
    """Map-style dataset.  ``__getitem__`` must accept a LIST of indices
    (fancy index): that is how ``DataLoader`` fetches whole batches in one
    shot instead of per-sample gathers."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class Sampler:
    """Abstract stream of dataset indices."""

    def __init__(self, dataset: Dataset) -> None:
        pass

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):

    def __init__(self, dataset: Dataset) -> None:
        self.dataset = dataset

    def __iter__(self):
        return iter(range(len(self)))

    def __len__(self) -> int:
        return len(self.dataset)


class RandomSampler(Sampler):
    """A fresh permutation per epoch, drawn from the global ``np.random``
    stream (seed parity: ``np.random.seed(s)`` fixes the epoch order exactly
    as in the JAX package)."""

    def __init__(self, dataset: Dataset) -> None:
        self.dataset = dataset

    def __iter__(self):
        return iter(np.random.permutation(len(self)).tolist())

    def __len__(self) -> int:
        return len(self.dataset)


class BatchSampler(Sampler):
    """Chunks a sampler's index stream into ``batch_size``-long lists; a
    trailing partial batch is dropped iff ``drop_last``."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 drop_last: bool) -> None:
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        stream = iter(self.sampler)
        while batch := list(itertools.islice(stream, self.batch_size)):
            if len(batch) == self.batch_size or not self.drop_last:
                yield batch

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)


def _batches(loader):
    """Synchronous batch stream: one dataset fancy-index per index batch."""
    for index in loader.batch_sampler:
        yield loader.dataset[index]


class _PrefetchIter:
    """Background-thread prefetch with shutdown-safe handoff.

    The worker fills a bounded queue; its ``put`` polls the stop flag so a
    consumer that abandons iteration (break / exception / GC) cannot leave
    the thread blocked on a full queue forever, pinning ``depth`` assembled
    batches and the dataset.  Symmetrically, the consumer's ``get`` polls
    worker liveness: after ``close()`` the worker's end-of-stream sentinel
    may never have been enqueued (its stop-aware put returns False), so a
    blocking ``get`` would deadlock — instead a dead/stopped worker with an
    empty queue ends iteration.
    """

    _DONE = object()

    def __init__(self, loader, depth: int) -> None:
        self._q = queue.Queue(maxsize=depth)
        self._error = None
        self._stop = threading.Event()
        # draw the epoch's index order on the CALLING thread: the sampler
        # may consume the global np.random stream (RandomSampler), and
        # the documented seed parity must not depend on how the worker
        # thread interleaves with the main thread's own np.random draws —
        # only the dataset fancy-index fetches run in the background
        index_batches = list(loader.batch_sampler)
        source = (loader.dataset[idx] for idx in index_batches)

        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for batch in source:
                    if not offer(batch):
                        return
            except BaseException as e:  # re-raised in the consumer thread
                self._error = e
            finally:
                offer(self._DONE)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()

    __del__ = close

    def _finish(self):
        if self._error is not None:
            raise self._error
        raise StopIteration

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    # the sentinel may be racing in — drain once more before
                    # declaring the stream over
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self._finish()
        if item is self._DONE:
            self._finish()
        return item

    def __iter__(self):
        return self


class DataLoader:

    def __init__(self, dataset: Dataset, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 prefetch: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.sampler = (RandomSampler if shuffle else
                        SequentialSampler)(dataset)
        self.batch_sampler = BatchSampler(self.sampler, batch_size, drop_last)

    def __iter__(self):
        if self.prefetch > 0:
            return _PrefetchIter(self, self.prefetch)
        return _batches(self)

    def __len__(self):
        return len(self.batch_sampler)


def data_loader(X, y, batch_size: int, shuffle: bool = False) -> DataLoader:
    """Convenience (X, y) loader."""

    class TrainSet(Dataset):

        def __init__(self, X, y) -> None:
            self.data = X
            self.target = y

        def __getitem__(self, index):
            return self.data[index], self.target[index]

        def __len__(self):
            return len(self.data)

    return DataLoader(TrainSet(X, y), batch_size, shuffle)
