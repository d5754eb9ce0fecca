"""What the input path's host threads cost the train step, and whether the
integrity check of ``chip_smoke.py`` can see a slot overwritten under a
step.

    python -m maskflownet_torch.tools.input_probe [--steps 20]
        [--out PATH]

Run from the root of the repo: it imports ``chip_smoke.py``'s integrity
check. The step is ``chip_smoke.py``'s: the chairs presets' augmented
bf16 MaskFlownet_S step, batch 8, 384x512 sources to 320x448 crops,
seeded weights, fed through ``Trainer.train_batch_device``. The host data
are 16 random samples at 384x512 held in memory (no files). ms/step
(``--steps`` steps after 2 of warm-up, ended by one synchronize) for each
way of running the host side beside the step that ``chip_smoke.py`` does
not time:

* ``serving``: a ``DeviceBatchCache`` whose source has ended, the
  baseline of this process's readings;
* ``refresh``: a cache refreshed from an in-memory source that returns a
  ready host batch at once (the refresh thread alone: pinning, copies);
* ``loader``: the serving cache, with a ``TrainLoader([Dataset] * 8)``
  drained by a thread of its own (the loader's 8 producers and mixer
  alone);
* ``loader+refresh``: a cache refreshed from the loader (the JAX CLI's
  device-cache path), also with the interpreter's switch interval cut
  from 5 ms to 0.5 ms (``sys.setswitchinterval``);

with the transfers a step made. Then the negative control of the
integrity check: ``chip_smoke.integrity`` on a cache of 2 slots and a
prefetcher of depth 2, with ``Tensor.record_stream`` and the prefetcher's
``wait_event`` removed, counting the steps whose served tensors no
longer match their index's checksums (``chip_smoke.py`` requires 0 with
them in place). Prints a line a reading and writes them as JSON to
``--out`` (default ``build/input_probe.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import maskflownet_torch.data.device_cache as cache_module
import maskflownet_torch.parallel.mesh as mesh_module
from chip_smoke import TaggedSource, integrity
from maskflownet_torch.config import (ORIG_SHAPE, color_aug_config,
                                      geometry_aug_config)
from maskflownet_torch.data import (Dataset, DeviceBatchCache, TrainLoader,
                                    with_mask)
from maskflownet_torch.models import init_params
from maskflownet_torch.parallel import DevicePrefetcher
from maskflownet_torch.training import TrainSettings, Trainer

BATCH, CROP, LR = 8, (320, 448), 1e-4


def _unguarded():
    """Patches that take ``record_stream`` out of the cache's and the
    prefetcher's serving, and the compute stream's wait for the copy out
    of the prefetcher."""
    def serve(tensors, device):
        return tensors

    def get(self):
        item = self._q.get()
        return None if item is None else item[0]

    return (mock.patch.object(cache_module, "serve", serve),
            mock.patch.object(mesh_module, "serve", serve),
            mock.patch.object(mesh_module.DevicePrefetcher, "get", get))


def host_batches(rng, n: int, hw):
    h, w = hw
    return [(rng.randint(0, 256, (BATCH, h, w, 3), np.uint8),
             rng.randint(0, 256, (BATCH, h, w, 3), np.uint8),
             (5 * rng.randn(BATCH, h, w, 2)).astype(np.float16),
             np.full((BATCH, 1, 1, 1), 255, np.uint8)) for _ in range(n)]


def ms_per_step(trainer, get, steps: int) -> float:
    for _ in range(2):
        trainer.train_batch_device(get(), lr=LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_batch_device(get(), lr=LR)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="build/input_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("input_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    src_hw = ORIG_SHAPE["chairs"]
    trainer = Trainer(TrainSettings(
        color=color_aug_config("chairs"),
        geo=geometry_aug_config("chairs", CROP, src_hw)), device="cuda",
        params=init_params(0))
    rng = np.random.RandomState(0)
    ready = host_batches(rng, 8, src_hw)
    h, w = src_hw
    samples = ([rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(16)],
               [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(16)],
               [(5 * rng.randn(h, w, 2)).astype(np.float32)
                for _ in range(16)])
    readings = {"device": smi, "steps": args.steps}

    def report(name, ms, transfers=None):
        readings[name] = {"ms_per_step": ms, "transfers_per_step":
                          None if transfers is None else
                          transfers / (args.steps + 2)}
        more = ("" if transfers is None else
                f", {transfers / (args.steps + 2):.2f} transfers a step")
        print(f"input_probe {name}: {ms:.3f} ms/step{more} ({smi})",
              flush=True)

    serving = DeviceBatchCache(lambda it=iter(ready): next(it, None))
    serving._thread.join()
    report("serving", ms_per_step(trainer, serving.get, args.steps))

    k = iter(range(10 ** 9))
    cache = DeviceBatchCache(lambda: ready[next(k) % len(ready)], slots=8)
    cache.get()
    cache.reset_stats()
    report("refresh", ms_per_step(trainer, cache.get, args.steps),
           cache.transfers)
    cache.stop()

    loader = TrainLoader([Dataset(samples)] * BATCH, BATCH, src_hw, seed=0)
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            loader.get()

    sink = threading.Thread(target=drain, daemon=True)
    sink.start()
    report("loader", ms_per_step(trainer, serving.get, args.steps))
    stop.set()
    sink.join(timeout=60)

    for switch in (0.005, 0.0005):
        old = sys.getswitchinterval()
        sys.setswitchinterval(switch)
        try:
            cache = DeviceBatchCache(loader.get, slots=8, transform=with_mask)
            cache.get()
            cache.reset_stats()
            report(f"loader+refresh, switch interval {switch * 1e3:g} ms",
                   ms_per_step(trainer, cache.get, args.steps),
                   cache.transfers)
            cache.stop()
        finally:
            sys.setswitchinterval(old)

    bases = host_batches(rng, 2, src_hw)
    for name, make in (("cache (2 slots)",
                        lambda s: DeviceBatchCache(s, slots=2)),
                       ("prefetcher (depth 2)",
                        lambda s: DevicePrefetcher(s, depth=2))):
        for guarded in (True, False):
            source = TaggedSource(bases)
            with contextlib.ExitStack() as stack:
                for patch in () if guarded else _unguarded():
                    stack.enter_context(patch)
                served, bad, transfers = integrity(make(source), source,
                                                   trainer, 30)
            key = (f"integrity {name}, "
                   f"{'as built' if guarded else 'unguarded'}")
            readings[key] = {"steps": len(served), "mismatched": len(bad),
                             "transfers": transfers}
            print(f"input_probe {key}: {len(bad)} of {len(served)} steps "
                  f"served tensors that changed under the step, "
                  f"{transfers} transfers", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
