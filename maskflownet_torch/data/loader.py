"""Host-side input pipeline: shuffled per-dataset streams, random crop +
horizontal flip, fixed-ratio batch mixing, threaded prefetch. The port's
copy of ``maskflownet_tpu/data/loader.py``: with the same seed it yields
the same batches.

Replicates the reference loader semantics (``main.py:421-509``):
  * per-dataset daemon thread yielding shuffled epochs,
  * random crop to ``orig_shape`` when the source frame is larger,
  * 50% horizontal flip with dx-negation (the reference comment says
    "vertical" but flips the W axis, ``main.py:474-477``; here flow is
    (dy, dx) so channel 1 is negated),
  * a mixer assembling batches with a fixed per-dataset sample count
    (dataset mixing by list replication, ``main.py:244-260``),
  * bounded queues for prefetch, and a ``stop()`` that ends every thread
    (the JAX loader's threads run until the interpreter exits).

Per-host sharding (each host keeps every ``num_shards``-th epoch index,
offset by its ``shard_index``) and NHWC output: the device step takes
uint8 NHWC images and f16 flow and converts them on the device
(``Trainer.train_batch_device``).

The crop and flip are numpy slices. The JAX package can run them in its
native C++ runtime instead, whose crop is a copy: both give the same
arrays.
"""

from __future__ import annotations

import threading
from queue import Empty, Full, Queue

import numpy as np

# the producers' and the mixer's queue bounds (samples per dataset, then
# batches), and the flow's dtype on the wire: f16 halves the host->device
# bytes of the largest batch tensor (the device step upcasts to f32; the
# rounding is <=0.25 px at Sintel's max |flow| ~450, negligible against
# label noise)
QUEUE_DEPTH, BATCH_DEPTH = 100, 10
FLOW_DTYPE = np.float16
# how often a thread blocked on a queue looks at its stop event, and how
# long TrainLoader.stop() waits for each thread
POLL_S, JOIN_TIMEOUT_S = 0.1, 30.0


class Dataset:
    """One training source: parallel lists of per-sample arrays or file
    paths with a ``load`` callable. ``arrays`` entries are (img1, img2, flow)
    or (img1, img2, flow, mask)."""

    def __init__(self, arrays: tuple, load=None):
        self.arrays = arrays
        self.load = load

    def __len__(self):
        return len(self.arrays[0])

    def get(self, i: int) -> list[np.ndarray]:
        items = [a[i] for a in self.arrays]
        if self.load is not None:
            items = [self.load(x) if isinstance(x, str) else x for x in items]
        return items


def _crop_flip(items: list[np.ndarray], orig_shape,
               rng: np.random.RandomState) -> list[np.ndarray]:
    """Random crop to orig_shape + 50% horizontal flip. items are HWC;
    item 2 is flow (dy, dx)."""
    oh, ow = orig_shape
    sh, sw = items[0].shape[:2]
    space_y, space_x = sh - oh, sw - ow
    y0 = rng.randint(space_y) if space_y else 0
    x0 = rng.randint(space_x) if space_x else 0
    flip = bool(rng.randint(2))
    out = []
    for arr in items:
        a = arr[y0:y0 + oh, x0:x0 + ow]
        if flip:
            a = a[:, ::-1]
        out.append(np.ascontiguousarray(a))
    if flip:
        out[2] = np.stack([out[2][..., 0], -out[2][..., 1]], axis=-1)
    return out


def _put(queue: Queue, item, stop: threading.Event | None) -> bool:
    """``queue.put(item)``; with ``stop``, give up (False) once it is set."""
    while stop is not None:
        if stop.is_set():
            return False
        try:
            queue.put(item, timeout=POLL_S)
            return True
        except Full:
            continue
    queue.put(item)
    return True


def _get(queue: Queue, stop: threading.Event | None):
    """``queue.get()``; with ``stop``, give up (None) once it is set."""
    while stop is not None:
        if stop.is_set():
            return None
        try:
            return queue.get(timeout=POLL_S)
        except Empty:
            continue
    return queue.get()


def iterate_data(queue: Queue, dataset: Dataset, orig_shape, seed: int,
                 shard_index: int = 0, num_shards: int = 1,
                 stop: threading.Event | None = None) -> None:
    """Producer thread: shuffled epochs, sharded across hosts, crop+flip,
    flow in FLOW_DTYPE; returns once ``stop`` is set."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    indices = np.arange(n)
    while True:
        rng.shuffle(indices)
        for i in indices[shard_index::num_shards]:
            items = dataset.get(int(i))
            items = [np.asarray(a) for a in items]
            if items[2].dtype == np.float16:
                items[2] = items[2].astype(np.float32)
            items = _crop_flip(items, orig_shape, rng)
            items[2] = items[2].astype(FLOW_DTYPE)
            if not _put(queue, items, stop):
                return


def batch_samples(in_queues: list[Queue], out_queue: Queue,
                  batch_size: int,
                  stop: threading.Event | None = None) -> None:
    """Mixer thread: fixed-ratio assembly (reference ``main.py:480-486``);
    returns once ``stop`` is set."""
    per = batch_size // len(in_queues)
    while True:
        batch = []
        for q in in_queues:
            for _ in range(per):
                item = _get(q, stop)
                if item is None:
                    return
                batch.append(item)
        if not _put(out_queue, [np.stack(x, axis=0) for x in zip(*batch)],
                    stop):
            return


class TrainLoader:
    """Threaded, sharded training loader.

    ``datasets`` is a list of :class:`Dataset` (replicated entries give the
    mixing ratio, like the reference's ``training_datasets`` list).
    """

    def __init__(self, datasets: list[Dataset], batch_size: int,
                 orig_shape: tuple[int, int], seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        if batch_size % len(datasets):
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"the {len(datasets)} datasets")
        self.batch_queue: Queue = Queue(maxsize=BATCH_DEPTH)
        self._queues = [Queue(maxsize=QUEUE_DEPTH) for _ in datasets]
        self._stop = threading.Event()
        self._threads = []
        for k, (q, ds) in enumerate(zip(self._queues, datasets)):
            t = threading.Thread(
                target=iterate_data,
                args=(q, ds, orig_shape, seed * 1000 + k, shard_index,
                      num_shards, self._stop),
                daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(
            target=batch_samples,
            args=(self._queues, self.batch_queue, batch_size, self._stop),
            daemon=True)
        t.start()
        self._threads.append(t)

    def get(self):
        """Next batch: [img1, img2, flow] or [img1, img2, flow, mask],
        stacked NHWC."""
        return self.batch_queue.get()

    def stop(self) -> None:
        """Stop the producers and the mixer and wait for them (each ends
        within ``POLL_S`` of a blocked queue operation, or after the
        sample it is decoding). Stop the loader's consumers first: a
        ``get()`` after ``stop()`` may wait for ever."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT_S)


def with_mask(batch):
    """The JAX CLI's transform before a batch goes to the card
    (``maskflownet_tpu/cli/main.py:391-395``): a (B,1,1,1) uint8 mask of
    255 appended to a batch without one."""
    if len(batch) == 3:
        return (*batch, np.full((batch[0].shape[0], 1, 1, 1), 255, np.uint8))
    return tuple(batch)
