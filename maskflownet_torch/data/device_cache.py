"""Device-resident batch cache with background refresh (bounded data
echoing): the port of ``maskflownet_tpu/data/device_cache.py``.

``DeviceBatchCache`` keeps ``slots`` full batches resident in device
memory. The training loop samples a slot every step (uniform, no immediate
repeat) while a daemon thread keeps streaming fresh host batches to the
device, replacing slots round-robin. Each transferred batch is therefore
reused ``~step_rate/refresh_rate`` times -- bounded data echoing (Choi et
al. 2020, "Faster Neural Network Training with Data Echoing",
arXiv:1907.05550). The JAX package built it for a TPU whose host link was
slower than its step. On a card the step is launch-bound on the host, and
the refresh thread, which never waits, competes with it for the
interpreter: on an H100 it slows the augmented S step measurably, and
with the loader's threads several times over (the numbers, card and power
limit: PERF.md §5 and §7). How the refresh is paced is left to the port's
benchmark.

How benign echoing is depends on where augmentation runs. With ``geo``
and ``color`` in the ``TrainSettings``, ``Trainer.train_batch_device``
draws both afresh from the trainer's generator at every step, so every
echo of a slot gets new geometry and colour. The factor is tracked
(:attr:`echo_factor`) so that it is seen rather than assumed away.

On a CUDA device the refresh thread copies on a side stream from pinned
memory and publishes a slot only after its copy has finished (the JAX
cache's ``block_until_ready``); :meth:`get` records every tensor it serves
on the caller's current stream, so that a replaced slot's memory is not
given to a later copy while a step queued on that stream may still read it
(``parallel/mesh.py``).
"""

from __future__ import annotations

import random
import threading

import torch

from maskflownet_torch import get_device
from maskflownet_torch.parallel.mesh import JOIN_TIMEOUT_S, serve, to_device


class DeviceBatchCache:
    """Pool of device-resident batches fed by ``source()`` on a daemon thread.

    Parameters
    ----------
    source: callable returning the next host batch (tuple of numpy arrays),
        or None to signal exhaustion (refresh then stops; cached slots keep
        serving).
    device: where the batches live (``"cuda"`` by default; ``"cpu"`` only
        when asked).
    slots: number of batches to keep resident. Device memory = slots *
        batch_bytes (a FlyingChairs batch of 8 at 384x512 with f16 flow
        and a (B,1,1,1) mask is ~15.7 MB).
    transform: optional host-side preprocessing before transfer.
    seed: RNG seed for slot sampling.
    """

    def __init__(self, source, device: str | torch.device = "cuda",
                 slots: int = 16, transform=None, seed: int = 0):
        self.device = get_device(device)
        self._slots: list = [None] * slots
        self._n_ready = 0
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._stop = False
        self._rng = random.Random(seed)
        self._last = -1
        self.transfers = 0      # batches that crossed the wire
        self.serves = 0         # batches handed to the training loop
        self._error: BaseException | None = None

        def worker():
            try:
                self._fill(source, transform, slots)
            except BaseException as e:  # surface in get(), don't hang
                self._error = e
                self._ready.set()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _fill(self, source, transform, slots):
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        i = 0
        while not self._stop:
            batch = source()
            if batch is None:
                break
            if transform is not None:
                batch = transform(batch)
            dev, event = to_device(batch, self.device, side)
            if event is not None:
                event.synchronize()     # resident before it is served
            with self._lock:
                self._slots[i % slots] = dev
                self._n_ready = min(self._n_ready + 1, slots)
                self.transfers += 1
            self._ready.set()
            i += 1

    def get(self):
        """A device-resident batch; blocks only until the first slot fills."""
        self._ready.wait()
        if self._error is not None:
            raise RuntimeError("DeviceBatchCache refresh thread failed") \
                from self._error
        with self._lock:
            n = self._n_ready
            if 0 <= self._last < n and n > 1:
                j = self._rng.randrange(n - 1)
                if j >= self._last:
                    j += 1          # uniform over ready slots != last
            else:
                j = self._rng.randrange(n) if n > 1 else 0
            self._last = j
            self.serves += 1
            return serve(self._slots[j], self.device)

    @property
    def echo_factor(self) -> float:
        """Mean reuses per transferred batch so far."""
        with self._lock:
            return self.serves / max(1, self.transfers)

    def reset_stats(self) -> None:
        """Zero the serve/transfer counters under the refresh thread's lock
        (an unsynchronized reset races the thread's ``transfers += 1``)."""
        with self._lock:
            self.serves = 0
            self.transfers = 0

    def stop(self):
        """Signal the refresh thread and wait for it to finish its in-flight
        transfer, so that no copy is in flight when the interpreter tears
        down the CUDA runtime."""
        self._stop = True
        self._thread.join(timeout=JOIN_TIMEOUT_S)
