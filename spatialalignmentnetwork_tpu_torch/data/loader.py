"""Host-side batching loader with threaded prefetch (the port's own copy of
the JAX package's `data/loader.py`).

The reference feeds training through torch DataLoader worker processes
(its train.py:155-160). h5py slice reads are IO-bound and release the
GIL, so a thread pool feeding a small queue keeps the card busy without
forking processes. Batches are stacked numpy arrays; `device_prefetch`
copies them to the model's device from pinned host memory without
blocking, a few batches ahead.
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class Prefetch:
    """A whole dataset materialised in RAM (the reference's
    train.py:24-33)."""

    def __init__(self, dataset, workers=8):
        with ThreadPoolExecutor(workers) as ex:
            self.items = list(ex.map(lambda i: dataset[i], range(len(dataset))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, ind):
        return self.items[ind]


def to_device(a, device):
    """A numpy array as a tensor on `device`; to a card through pinned host
    memory, without blocking, so that the copy overlaps the work already
    queued."""
    device = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def device_prefetch(iterator, device, size=2):
    """Batches of `iterator` (lists of numpy arrays) as tensors on `device`
    (`to_device`), `size` batches staged ahead."""
    buf = collections.deque()
    for batch in iterator:
        buf.append([to_device(x, device) for x in batch])
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class Loader:
    """Iterate batches of stacked modality lists.

    Each dataset item is a list [target, aux, ...] of [C, H, W] arrays; a
    batch is a list of [N, C, H, W] stacked arrays, one a modality.

    Sharding: with num_shards=P, shard_index=p, every process draws the
    same global permutation (callers pass the same seed on every host) in
    global batches of batch_size * P rows, and this loader yields rows
    [p * B, (p + 1) * B) of each, so that the P processes load disjoint
    rows whose union is the global batch.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=4, prefetch_batches=2, seed=0,
                 num_shards=1, shard_index=0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        if num_shards > 1 and not drop_last:
            raise ValueError(
                "sharded loading requires drop_last=True so every process "
                "yields the same number of equal-size batches"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self):
        n = len(self.dataset)
        global_bs = self.batch_size * self.num_shards
        if self.drop_last:
            return n // global_bs
        return (n + global_bs - 1) // global_bs

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        global_bs = self.batch_size * self.num_shards
        lo = self.shard_index * self.batch_size
        for b in range(len(self)):
            gbatch = order[b * global_bs:(b + 1) * global_bs]
            yield gbatch[lo:lo + self.batch_size]

    def _fetch(self, indices):
        if hasattr(self.dataset, "batch"):
            # native batch assembly (data.native_cache.NativePairedSlices):
            # one OpenMP crop pass instead of per-item reads
            return self.dataset.batch(np.asarray(indices))
        items = [self.dataset[int(i)] for i in indices]
        return [np.stack([it[m] for it in items], axis=0) for m in range(len(items[0]))]

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch_batches)
        stop = object()
        cancel = threading.Event()

        def put(item):
            """A bounded put that gives up once the consumer is gone: a
            plain q.put would block forever when the iterator is abandoned
            mid-epoch (the train loop's intel_stop break), pinning the
            producer thread and its batches for the rest of the process."""
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # a bounded window of fetches in flight, so memory stays
            # O(workers + prefetch) batches; a worker's exception goes to
            # the consumer and is raised there, where a producer dying
            # without a sentinel would leave it blocked on q.get()
            try:
                window = collections.deque()
                with ThreadPoolExecutor(self.num_workers) as ex:
                    for idx in self._batches():
                        if cancel.is_set():
                            return
                        window.append(ex.submit(self._fetch, idx))
                        while len(window) >= self.num_workers:
                            if not put(window.popleft().result()):
                                return
                    while window:
                        if not put(window.popleft().result()):
                            return
                put(stop)
            except BaseException as e:  # noqa: BLE001 (relayed to the consumer, raised there)
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on abandonment (GeneratorExit): release the
            # producer, then drain what it already queued
            cancel.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
