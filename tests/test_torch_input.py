"""The port's device input path on the CPU (``device="cpu"``):
``DeviceBatchCache``, ``DevicePrefetcher``, ``Trainer.train_batch_device``,
``Trainer.do_batch`` and ``Trainer.predict``.

The cache's slot sampling is held against the JAX ``DeviceBatchCache``
(on one JAX CPU device: a ``device_put``, no compile). The step is held
bitwise against ``Trainer.train_batch`` on the same batch given as NCHW,
which ``tests/test_torch_training.py`` holds against the JAX step; the
inference delegates against ``Predictor``, which
``tests/test_torch_model.py`` holds against JAX. Shapes: 64x64 crops from
96x128 sources, batch 2, f32."""

import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from maskflownet_tpu.data.device_cache import \
    DeviceBatchCache as JaxDeviceBatchCache
from maskflownet_tpu.parallel.mesh import make_mesh
from maskflownet_torch.config import presets
from maskflownet_torch.data import (Dataset, DeviceBatchCache, TrainLoader,
                                    chairs, codecs, with_mask)
from maskflownet_torch.inference import Predictor
from maskflownet_torch.models import init_params
from maskflownet_torch.parallel import DevicePrefetcher
from maskflownet_torch.training import TrainSettings, Trainer

B, SRC, CROP = 2, (96, 128), (64, 64)
TIMEOUT = 30


def tagged(tag: int, hw=(2, 3)):
    """A tiny loader-layout batch whose every value is ``tag``."""
    h, w = hw
    return (np.full((1, h, w, 3), tag, np.uint8),
            np.full((1, h, w, 3), tag, np.uint8),
            np.full((1, h, w, 2), tag, np.float16),
            np.full((1, 1, 1, 1), 255, np.uint8))


def finite_source(n: int):
    """Tagged batches 0..n-1, then None (the end of the source)."""
    it = iter(range(n))
    return lambda: None if (i := next(it, None)) is None else tagged(i)


def tag_of(batch) -> int:
    return int(batch[0][0, 0, 0, 0])


def wait_until(cond, what: str):
    end = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# DeviceBatchCache
# ---------------------------------------------------------------------------

def test_cache_blocks_until_the_first_slot_fills():
    release = threading.Event()
    source = finite_source(1)

    def slow_source():
        release.wait(TIMEOUT)
        return source()

    cache = DeviceBatchCache(slow_source, device="cpu", slots=4)
    got = []
    t = threading.Thread(target=lambda: got.append(cache.get()))
    t.start()
    time.sleep(0.2)
    assert not got and t.is_alive()
    release.set()
    t.join(TIMEOUT)
    assert not t.is_alive() and tag_of(got[0]) == 0
    cache.stop()
    assert not cache._thread.is_alive()


def test_cache_serves_the_source_and_counts_echoes():
    cache = DeviceBatchCache(finite_source(3), device="cpu", slots=8,
                             transform=lambda b: b[:3])
    cache._thread.join(TIMEOUT)            # the source ends after 3
    assert not cache._thread.is_alive()
    served = [cache.get() for _ in range(12)]
    tags = [tag_of(b) for b in served]
    assert set(tags) == {0, 1, 2}
    assert all(a != b for a, b in zip(tags, tags[1:]))   # no repeat
    for b, tag in zip(served, tags):
        assert len(b) == 3                 # the transform ran
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in b)
        np.testing.assert_array_equal(b[2].numpy(), tagged(tag)[2])
    assert (cache.transfers, cache.serves, cache.echo_factor) == (3, 12, 4.0)
    cache.reset_stats()
    assert (cache.transfers, cache.serves, cache.echo_factor) == (0, 0, 0.0)
    cache.get()
    assert (cache.serves, cache.echo_factor) == (1, 1.0)


def test_cache_copies_the_host_batch():
    batch = tagged(5)
    cache = DeviceBatchCache(lambda it=iter([batch]): next(it, None),
                             device="cpu", slots=1)
    served = cache.get()
    batch[0][...] = 9                      # the host buffer is reused
    assert tag_of(served) == 5 and tag_of(cache.get()) == 5


def test_cache_reraises_a_source_error():
    def broken():
        raise ValueError("no more data")

    cache = DeviceBatchCache(broken, device="cpu")
    with pytest.raises(RuntimeError, match="refresh thread failed") as info:
        cache.get()
    assert isinstance(info.value.__cause__, ValueError)


def test_cache_stop_joins_a_refreshing_thread():
    count = iter(range(10 ** 9))
    cache = DeviceBatchCache(lambda: tagged(next(count) % 200),
                             device="cpu", slots=2)
    cache.get()
    wait_until(lambda: cache.transfers > 5, "refreshes")
    cache.stop()
    assert not cache._thread.is_alive()
    n = cache.transfers
    time.sleep(0.05)
    assert cache.transfers == n


def test_cache_counts_hold_under_thread_stress():
    """16 consumers against the refresh thread, the interpreter switching
    threads every microsecond: no serve or transfer is lost."""
    produced = itertools.count()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cache = DeviceBatchCache(lambda: tagged(next(produced) % 200),
                                 device="cpu", slots=3)
        tags = []
        threads = [threading.Thread(target=lambda: tags.extend(
            tag_of(cache.get()) for _ in range(100))) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        cache.stop()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not cache._thread.is_alive()
    assert len(tags) == cache.serves == 1600
    assert next(produced) == cache.transfers    # every batch published
    assert all(0 <= t < 200 for t in tags)


@pytest.mark.parametrize("slots,seed,n", [(4, 0, 4), (5, 3, 5), (6, 1, 2),
                                          (1, 2, 1)])
def test_cache_serves_the_jax_cache_sequence(slots, seed, n):
    """Once the slots hold what they will hold (the source ends after
    ``n`` batches), the port serves the JAX cache's sequence of batches."""
    ours = DeviceBatchCache(finite_source(n), device="cpu", slots=slots,
                            seed=seed)
    theirs = JaxDeviceBatchCache(finite_source(n),
                                 make_mesh(jax.devices()[:1]), slots=slots,
                                 seed=seed)
    for cache in (ours, theirs):
        cache._thread.join(TIMEOUT)
        assert not cache._thread.is_alive() and cache.transfers == n
    got = [tag_of(ours.get()) for _ in range(40)]
    want = [int(np.asarray(theirs.get()[0])[0, 0, 0, 0]) for _ in range(40)]
    assert got == want
    assert ours.echo_factor == theirs.echo_factor == 40 / n


# ---------------------------------------------------------------------------
# DevicePrefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_order_and_ends_with_the_source():
    pre = DevicePrefetcher(finite_source(5), device="cpu", depth=2,
                           transform=lambda b: b[:3])
    got = [pre.get() for _ in range(5)]
    assert [tag_of(b) for b in got] == [0, 1, 2, 3, 4]
    assert all(len(b) == 3 and b[0].dtype == torch.uint8 for b in got)
    assert pre.get() is None
    pre.stop()
    assert not pre._thread.is_alive()


def test_prefetcher_reraises_a_source_error():
    """The batches before the error are served; then get() raises it
    instead of waiting for a batch that never comes."""
    source = finite_source(2)

    def breaks_after_two():
        batch = source()
        if batch is None:
            raise ValueError("no more data")
        return batch

    pre = DevicePrefetcher(breaks_after_two, device="cpu", depth=2)
    assert [tag_of(pre.get()) for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="worker failed") as info:
        pre.get()
    assert isinstance(info.value.__cause__, ValueError)
    pre.stop()
    assert not pre._thread.is_alive()


def test_prefetcher_stop_with_a_full_queue():
    count = iter(range(10 ** 9))
    pre = DevicePrefetcher(lambda: tagged(next(count) % 200), device="cpu",
                           depth=2)
    wait_until(pre._q.full, "a full queue")
    pre.stop()
    assert not pre._thread.is_alive()


# ---------------------------------------------------------------------------
# Trainer: train_batch_device, do_batch, predict
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return init_params(0)


def settings(aug: bool, dtype="float32"):
    if not aug:
        return TrainSettings(compute_dtype=dtype)
    return TrainSettings(compute_dtype=dtype,
                         color=presets.color_aug_config("chairs"),
                         geo=presets.geometry_aug_config("chairs", CROP, SRC))


def nhwc_batch(seed: int, hw, mask: str):
    """A loader-layout batch: uint8 images, f16 flow (dy, dx), a uint8
    mask of (B,1,1,1) or (B,H,W,1)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    batch = [rng.randint(0, 256, (B, h, w, 3), np.uint8),
             rng.randint(0, 256, (B, h, w, 3), np.uint8),
             (4 * rng.randn(B, h, w, 2)).astype(np.float16)]
    if mask == "per-sample":
        batch.append(np.full((B, 1, 1, 1), 255, np.uint8))
    else:
        batch.append((255 * (rng.rand(B, h, w, 1) > 0.3)).astype(np.uint8))
    return batch


@pytest.mark.parametrize("mask", ["per-sample", "full"])
@pytest.mark.parametrize("aug", [False, True])
def test_train_batch_device_equals_train_batch(params, aug, mask):
    host = nhwc_batch(1, SRC if aug else CROP, mask)
    device_batch = tuple(torch.from_numpy(x) for x in host)
    nchw = [np.ascontiguousarray(x.transpose(0, 3, 1, 2)) for x in host]
    s = settings(aug)
    ours = Trainer(s, device="cpu", params=params, seed=3)
    ref = Trainer(s, device="cpu", params=params, seed=3)
    # the same batch twice, an echo: the reference draws the augmentation
    # afresh at each call, so bitwise equality says the device path does too
    for _ in range(2):
        got = ours.train_batch_device(device_batch, lr=1e-4)
        want = ref.train_batch(*nchw, lr=1e-4)
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0
                   for v in got.values())
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["epe"], want["epe"])
    assert ours.steps == ref.steps == 2
    for k in ours.params:
        assert torch.equal(ours.params[k], ref.params[k]), k


def test_chairs_tree_through_loader_and_cache_to_the_step(params, tmp_path):
    """Files on disk to an augmented step: chairs reader, the CLI's
    replicated ``TrainLoader``, ``DeviceBatchCache`` with the mask
    appended, ``train_batch_device``."""
    rng = np.random.RandomState(2)
    h, w = chairs.SHAPE
    for i in (1, 2, 3):
        for j in (1, 2):
            img = rng.randint(0, 256, (h, w, 3), np.uint8)
            (tmp_path / ("%05d_img%d.ppm" % (i, j))).write_bytes(
                b"P6 512 384 255\n" + img.tobytes())
        codecs.flo_save(rng.randn(h, w, 2).astype(np.float32),
                        str(tmp_path / ("%05d_flow.flo" % i)))
    (tmp_path / "split.txt").write_text("1\n2\n1\n")
    train, val = chairs.read_trainval(str(tmp_path / "split.txt"))
    assert (train, val) == ([1, 3], [2])
    tr = chairs.load_set(train, str(tmp_path))
    loader = TrainLoader([Dataset(tr)] * B, B, SRC, seed=0)
    cache = DeviceBatchCache(loader.get, device="cpu", slots=2,
                             transform=with_mask)
    trainer = Trainer(settings(True), device="cpu", params=params)
    batch = cache.get()
    assert [tuple(t.shape) for t in batch] == [
        (B, *SRC, 3), (B, *SRC, 3), (B, *SRC, 2), (B, 1, 1, 1)]
    assert [t.dtype for t in batch] == [torch.uint8, torch.uint8,
                                        torch.float16, torch.uint8]
    losses = [trainer.train_batch_device(cache.get(), lr=1e-4,
                                         )["loss"].item() for _ in range(2)]
    assert all(np.isfinite(losses))
    cache.stop()
    assert not cache._thread.is_alive()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_do_batch_and_predict_delegate_to_predictor(params, dtype):
    s = settings(False, dtype)
    trainer = Trainer(s, device="cpu", params=params)
    host = nhwc_batch(4, CROP, "per-sample")
    trainer.train_batch_device(tuple(torch.from_numpy(x) for x in host))
    predictor = Predictor({k: v.detach() for k, v in trainer.params.items()},
                          device="cpu", dtype=s.dtype(), cfg=s.model_cfg,
                          model=s.model)
    img1, img2 = (torch.from_numpy(x).permute(0, 3, 1, 2).float() / 255
                  for x in host[:2])
    for got, want in zip(trainer.do_batch(img1, img2),
                         predictor.do_batch(img1, img2)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    frames = [list(host[0]) + [host[0][0]], list(host[1]) + [host[1][0]]]
    got = list(trainer.predict(*frames, batch_size=2))
    want = list(predictor.predict(*frames, batch_size=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert [a.shape for a in g] == [(*CROP, 2), (*CROP, 1), (*CROP, 3)]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aug", [False, True])
def test_permuted_inputs_reach_the_kernels_contiguous(params, aug,
                                                      monkeypatch):
    """``predict`` and ``validate`` hand ``do_batch`` NHWC frames
    transposed to NCHW views, and ``train_batch`` may be given such views;
    every cost volume must still get contiguous features and the sampler a
    contiguous image, since the CUDA kernels refuse any other layout (the
    CPU's plain versions take any strides, so only this spy sees it)."""
    import maskflownet_torch.augment.geometry as geometry
    import maskflownet_torch.models.maskflownet as model_module
    seen = []

    def spy(real, *which):
        def f(*args, **kwargs):
            seen.append(all(args[i].is_contiguous() for i in which))
            return real(*args, **kwargs)
        return f

    monkeypatch.setattr(model_module, "correlation",
                        spy(model_module.correlation, 0, 1))
    monkeypatch.setattr(geometry, "affine_sample",
                        spy(geometry.affine_sample, 0))
    trainer = Trainer(settings(aug), device="cpu", params=params)
    img1, img2, flow, _ = nhwc_batch(5, SRC if aug else CROP, "per-sample")
    views = [x.astype(np.float32).transpose(0, 3, 1, 2)
             for x in (img1, img2, flow)]
    trainer.train_batch(*views)
    frames = [list(img1[:, :CROP[0], :CROP[1]]),
              list(img2[:, :CROP[0], :CROP[1]])]
    list(trainer.predict(*frames, batch_size=2))
    flows = [f[:CROP[0], :CROP[1]].astype(np.float32) for f in flow]
    trainer.validate(*frames, flows, batch_size=2)
    assert len(seen) == (2 if aug else 0) + 5 * 3 and all(seen), seen
