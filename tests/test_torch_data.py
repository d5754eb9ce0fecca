"""The port's data modules against the JAX package's, on the same numpy
inputs and the same files: codecs, resize, the synthetic generators, the
FlyingChairs reader and the threaded loader. Equal bitwise throughout.
None of this compiles a JAX program."""

import struct
import threading
import zlib
from queue import Queue

import numpy as np
import pytest

from maskflownet_tpu.data import chairs as jax_chairs
from maskflownet_tpu.data import codecs as jax_codecs
from maskflownet_tpu.data import loader as jax_loader
from maskflownet_tpu.data import paths as jax_paths
from maskflownet_tpu.data import synthetic as jax_synthetic
from maskflownet_tpu.data.resize import resize_bilinear_np as jax_resize
from maskflownet_torch.data import chairs, codecs, loader, paths, synthetic
from maskflownet_torch.data.resize import resize_bilinear_np

SMALL = (24, 32)        # synthetic pairs: the generators are per-pixel numpy


def _equal(got, want):
    """Nested lists/tuples of arrays, equal in dtype, shape and bits."""
    assert type(got) is type(want) or {type(got), type(want)} <= {list,
                                                                   tuple}
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)


# ---------------------------------------------------------------------------
# paths and codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [{}, {"MFN_CHAIRS_DIR": "/x/chairs",
                                      "MFN_CHAIRS_SPLIT": "/x/split.txt",
                                      "MFN_SINTEL_ROOT": "/x/sintel",
                                      "MFN_KITTI_ROOT": "/x/kitti",
                                      "MFN_HD1K_ROOT": "/x/hd1k",
                                      "MFN_THINGS3D_ROOT": "/x/things"}])
def test_paths_match_jax(monkeypatch, env):
    for name in ("MFN_CHAIRS_DIR", "MFN_CHAIRS_SPLIT", "MFN_SINTEL_ROOT",
                 "MFN_SINTEL_SPLIT", "MFN_KITTI_ROOT", "MFN_HD1K_ROOT",
                 "MFN_THINGS3D_ROOT"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fn in ("chairs_dir", "chairs_split_file", "sintel_root",
               "sintel_split_file", "kitti_root", "hd1k_root",
               "things3d_root"):
        assert getattr(paths, fn)() == getattr(jax_paths, fn)()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flo_files_cross_both_ways(tmp_path, writer):
    rng = np.random.RandomState(1)
    arr = rng.randn(7, 9, 2).astype(np.float32)
    ours, theirs = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    codecs.flo_save(arr, ours)
    jax_codecs.flo_save(arr, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    path = ours if writer == "port" else theirs
    _equal(codecs.flo_load(path), jax_codecs.flo_load(path))
    _equal(codecs.read_flo_dydx(path, (7, 9)),
           jax_codecs.read_flo_dydx(path, (7, 9)))
    with pytest.raises(ValueError):
        codecs.flo_load(path, expect_shape=(9, 7))


def test_flo_bad_magic_raises_in_both(tmp_path):
    p = str(tmp_path / "bad.flo")
    with open(p, "wb") as fp:
        fp.write(struct.pack("<fii", 1.0, 4, 4) + b"\x00" * 128)
    for load in (codecs.flo_load, jax_codecs.flo_load):
        with pytest.raises(ValueError):
            load(p)


@pytest.mark.parametrize("header", [b"P6 512 384 255\n",
                                    b"P6\n# a comment\n512 384\n255\n"])
def test_ppm_load_matches_jax(tmp_path, header):
    arr = np.random.RandomState(2).randint(0, 256, (384, 512, 3), np.uint8)
    p = str(tmp_path / "a.ppm")
    with open(p, "wb") as fp:
        fp.write(header + arr.tobytes())
    got = codecs.ppm_load(p)
    _equal(got, jax_codecs.ppm_load(p))
    _equal(got, arr)


def _png_with_filters(path, arr, filters):
    """A 16-bit RGB PNG whose scanlines use ``filters`` in turn."""
    h, w, c = arr.shape
    bpp = c * 2
    rows = []
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ft = filters[y % len(filters)]
        raw = np.frombuffer(arr[y].astype(">u2").tobytes(),
                            np.uint8).astype(np.int32)
        enc = np.empty_like(raw)
        for i in range(len(raw)):
            a = raw[i - bpp] if i >= bpp else 0
            b = prev[i]
            cc = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else cc)
            enc[i] = raw[i] - pred
        rows.append(bytes([ft]) + (enc % 256).astype(np.uint8).tobytes())
        prev = raw

    def chunk(typ, payload):
        return (struct.pack(">I", len(payload)) + typ + payload
                + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0,
                                            0)))
        fp.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        fp.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png16_every_filter_matches_jax(tmp_path, filters):
    arr = np.random.RandomState(3).randint(0, 65536, (11, 13, 3)).astype(
        np.uint16)
    p = str(tmp_path / "f.png")
    _png_with_filters(p, arr, filters)
    got = codecs.png16_load(p)
    _equal(got, jax_codecs.png16_load(p))
    _equal(got, arr)


@pytest.mark.parametrize("shape", [(37, 53, 3), (5, 6, 1), (4, 7)])
def test_png16_save_matches_jax(tmp_path, shape):
    arr = np.random.RandomState(4).randint(0, 65536, shape).astype(np.uint16)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    codecs.png16_save(arr, ours)
    jax_codecs.png16_save(arr, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _equal(codecs.png16_load(theirs), jax_codecs.png16_load(ours))


def test_kitti_flow_codec_matches_jax():
    rng = np.random.RandomState(5)
    flow = (rng.randn(6, 8, 2) * 300).astype(np.float32)
    flow[0, 0] = 1e4                       # clipped on encode
    enc = codecs.kitti_flow_encode(flow)
    _equal(enc, jax_codecs.kitti_flow_encode(flow))
    enc[..., 2] = rng.randint(0, 2, (6, 8))
    _equal(codecs.kitti_flow_decode(enc), jax_codecs.kitti_flow_decode(enc))


# ---------------------------------------------------------------------------
# resize and the synthetic generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst,dtype", [((9, 13, 2), (20, 7), np.float32),
                                           ((24, 32, 3), (24, 32), np.uint8),
                                           ((2, 2, 1), (5, 9), np.uint8),
                                           ((17, 5, 3), (3, 11), np.float64)])
def test_resize_bilinear_np_matches_jax(src, dst, dtype):
    x = (np.random.RandomState(6).rand(*src) * 200).astype(dtype)
    _equal(resize_bilinear_np(x, *dst), jax_resize(x, *dst))


def test_make_dataset_matches_jax():
    got = synthetic.make_dataset(np.random.RandomState(7), 2, *SMALL)
    want = jax_synthetic.make_dataset(np.random.RandomState(7), 2, *SMALL)
    _equal(got, want)
    got = synthetic.make_dataset(np.random.RandomState(7), 1, *SMALL,
                                 max_rot=0.3, max_trans=0.1)
    want = jax_synthetic.make_dataset(np.random.RandomState(7), 1, *SMALL,
                                      max_rot=0.3, max_trans=0.1)
    _equal(got, want)


def test_make_occluded_dataset_matches_jax():
    got = synthetic.make_occluded_dataset(np.random.RandomState(8), 2,
                                          *SMALL, n_objects=3)
    want = jax_synthetic.make_occluded_dataset(np.random.RandomState(8), 2,
                                               *SMALL, n_objects=3)
    _equal(got, want)


# ---------------------------------------------------------------------------
# FlyingChairs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chairs_tree(tmp_path_factory):
    """4 samples at 384x512 and a split file of 4 lines (train, val,
    train, train)."""
    root = tmp_path_factory.mktemp("chairs")
    rng = np.random.RandomState(9)
    h, w = chairs.SHAPE
    for i in range(1, 5):
        for j in (1, 2):
            img = rng.randint(0, 256, (h, w, 3), np.uint8)
            with open(root / ("%05d_img%d.ppm" % (i, j)), "wb") as fp:
                fp.write(b"P6 512 384 255\n" + img.tobytes())
        codecs.flo_save(rng.randn(h, w, 2).astype(np.float32) * 10,
                        str(root / ("%05d_flow.flo" % i)))
    split = root / "split.txt"
    split.write_text("1\n2\n1\n1\n")
    return root, split


def test_chairs_read_trainval_and_load_set_match_jax(chairs_tree):
    root, split = chairs_tree
    got = chairs.read_trainval(str(split))
    assert got == jax_chairs.read_trainval(str(split)) == ([1, 3, 4], [2])
    _equal(chairs.load_set(got[0], str(root)),
           jax_chairs.load_set(got[0], str(root)))
    _equal(chairs.load_set(got[0], str(root), samples=2),
           jax_chairs.load_set(got[0], str(root), samples=2))
    assert chairs.load_set([], str(root)) == ([], [], [])


def test_chairs_env_paths_reach_the_reader(chairs_tree, monkeypatch):
    root, split = chairs_tree
    monkeypatch.setenv("MFN_CHAIRS_DIR", str(root))
    monkeypatch.setenv("MFN_CHAIRS_SPLIT", str(split))
    train, val = chairs.read_trainval()
    _equal(chairs.load_sample(val[0]), jax_chairs.load_sample(val[0]))


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_chairs_load_binary_matches_jax(tmp_path, dtype_bytes):
    h, w = chairs.SHAPE
    rng = np.random.RandomState(10)
    fdt = np.float32 if dtype_bytes == 4 else np.float16
    records = []
    for k in range(4):
        img1 = rng.randint(0, 256, (h, w, 3), np.uint8)
        img2 = rng.randint(0, 256, (h, w, 3), np.uint8)
        flow = rng.randn(h, w, 2).astype(fdt)
        if k == 1:
            flow[5, 7, 1] = np.nan          # dropped by both readers
        records.append(img1.tobytes() + img2.tobytes() + flow.tobytes())
    (tmp_path / "train0_3.bin").write_bytes(b"".join(records[:3]))
    (tmp_path / "train1_1.bin").write_bytes(records[3])
    (tmp_path / "val0_1.bin").write_bytes(records[0])
    for samples in (-1, 2):
        got = chairs.load_binary(str(tmp_path), "train", samples=samples,
                                 dtype_bytes=dtype_bytes)
        _equal(got, jax_chairs.load_binary(str(tmp_path), "train",
                                           samples=samples,
                                           dtype_bytes=dtype_bytes))
        assert len(got[0]) == (3 if samples == -1 else 2)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _columns(rng, n, hw, mask=False):
    h, w = hw
    cols = ([rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)],
            [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)],
            [(rng.randn(h, w, 2) * 5).astype(np.float32) for _ in range(n)])
    if mask:
        cols += ([rng.randint(0, 2, (h, w, 1)).astype(np.uint8) * 255
                  for _ in range(n)],)
    return cols


@pytest.mark.parametrize("src,crop", [((30, 40), (16, 24)),
                                      ((16, 24), (16, 24)),
                                      ((16, 40), (16, 24))])
def test_crop_flip_matches_jax(src, crop):
    cols = _columns(np.random.RandomState(11), 1, src, mask=True)
    items = [c[0] for c in cols]
    from maskflownet_tpu import native
    lib = native.load()
    for seed in range(6):                  # both sides of the flip
        got = loader._crop_flip(items, crop, np.random.RandomState(seed))
        for jlib in (None, lib):
            want = jax_loader._crop_flip(items, crop,
                                         np.random.RandomState(seed), jlib)
            _equal(got, want)


@pytest.mark.parametrize("mask", [False, True])
def test_train_loader_first_batches_match_jax(mask):
    rng = np.random.RandomState(12)
    ds_a = _columns(rng, 5, (20, 28), mask)
    ds_b = _columns(rng, 3, (24, 32), mask)
    got = loader.TrainLoader([loader.Dataset(ds_a), loader.Dataset(ds_b)],
                             4, (16, 24), seed=3)
    want = jax_loader.TrainLoader(
        [jax_loader.Dataset(ds_a), jax_loader.Dataset(ds_b)], 4, (16, 24),
        seed=3)
    for _ in range(3):
        g, w = got.get(), want.get()
        assert len(g) == (4 if mask else 3)
        assert g[0].shape == (4, 16, 24, 3) and g[2].dtype == np.float16
        _equal(g, w)


def test_train_loader_replicated_dataset_and_load_fn_match_jax():
    """The CLI's ``[Dataset(tr)] * batch_size``, with samples given as
    file names and a ``load`` callable."""
    rng = np.random.RandomState(13)
    store = dict(zip("abcdef", _columns(rng, 6, (16, 24))[0]))
    cols = _columns(rng, 6, (16, 24))
    cols = (list("abcdef"),) + cols[1:]
    got = loader.TrainLoader([loader.Dataset(cols, store.__getitem__)] * 4,
                             4, (16, 24), seed=0)
    want = jax_loader.TrainLoader(
        [jax_loader.Dataset(cols, store.__getitem__)] * 4, 4, (16, 24),
        seed=0)
    for _ in range(3):
        g, w = got.get(), want.get()
        assert g[2].dtype == np.float16
        _equal(g, w)


def test_sharded_iterate_data_matches_jax_and_partitions_epoch():
    n = 8
    img = [np.full((4, 4, 3), i, np.uint8) for i in range(n)]
    flow = [np.full((4, 4, 2), i, np.float16) for i in range(n)]
    seen = [set(), set()]
    for shard in (0, 1):
        out = []
        for fn, ds in ((loader.iterate_data, loader.Dataset((img, img,
                                                             flow))),
                       (jax_loader.iterate_data,
                        jax_loader.Dataset((img, img, flow)))):
            q = Queue(maxsize=n)
            threading.Thread(target=fn, args=(q, ds, (4, 4), 7, shard, 2),
                             daemon=True).start()
            out.append([q.get(timeout=30) for _ in range(n // 2)])
        _equal(out[0], out[1])
        seen[shard] = {int(items[0][0, 0, 0]) for items in out[0]}
    assert seen[0].isdisjoint(seen[1]) and len(seen[0] | seen[1]) == n


def test_train_loader_rejects_an_uneven_mix():
    ds = loader.Dataset(_columns(np.random.RandomState(14), 2, (8, 8)))
    with pytest.raises(ValueError):
        loader.TrainLoader([ds] * 3, 4, (8, 8))


def test_with_mask_appends_the_clis_mask():
    """The JAX CLI's ``_with_mask`` (a closure of its train loop): a
    (B,1,1,1) mask of 255 after a 3-array batch, a 4-array batch kept."""
    b = _columns(np.random.RandomState(15), 1, (8, 8))
    batch = [np.stack(c * 3) for c in b]
    got = loader.with_mask(batch)
    assert isinstance(got, tuple) and len(got) == 4
    _equal(got[:3], tuple(batch))
    assert got[3].dtype == np.uint8 and got[3].shape == (3, 1, 1, 1)
    assert (got[3] == 255).all()
    masked = (*batch, np.zeros((3, 8, 8, 1), np.uint8))
    _equal(loader.with_mask(list(masked)), masked)


@pytest.mark.parametrize("drain", [0, 3])
def test_train_loader_stop_ends_every_thread(drain):
    """``stop()`` ends the producers and the mixer, whether they block on
    full queues or are still producing (the JAX loader's run until exit),
    and the batches served before it are the JAX loader's."""
    ds = loader.Dataset(_columns(np.random.RandomState(15), 3, (8, 8)))
    ours = loader.TrainLoader([ds] * 2, 2, (8, 8), seed=4)
    theirs = jax_loader.TrainLoader([jax_loader.Dataset(ds.arrays)] * 2, 2,
                                    (8, 8), seed=4)
    for _ in range(drain):
        _equal(ours.get(), theirs.get())
    ours.stop()
    assert len(ours._threads) == 3
    assert not any(t.is_alive() for t in ours._threads)
