"""The port's dataset readers, PNG decoder, host-side geometric
augmentation, flow colouring and submission writers against the JAX
package's, on the same files and the same numpy inputs: bitwise, except
the host augmentation (1e-5). None of this compiles a JAX program; the
JAX side is its numpy functions only.

The tree builders here (Sintel, KITTI, HD1K, FlyingThings3D) also serve
``tests/test_torch_cli.py``."""

import os
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

import maskflownet_tpu.augment.host_geometry as jax_host_geometry
from maskflownet_torch.augment import host_geometry
from maskflownet_torch.augment.geometry import GeometryAugConfig
from maskflownet_torch.config import presets
from maskflownet_torch.data import codecs, hd1k, kitti, sintel, things3d
from maskflownet_torch.tools import flow_vis, submission
from maskflownet_tpu.augment.geometry import \
    GeometryAugConfig as JaxGeometryAugConfig
from maskflownet_tpu.data import codecs as jax_codecs
from maskflownet_tpu.data import hd1k as jax_hd1k
from maskflownet_tpu.data import kitti as jax_kitti
from maskflownet_tpu.data import sintel as jax_sintel
from maskflownet_tpu.data import things3d as jax_things3d
from maskflownet_tpu.tools import flow_vis as jax_flow_vis
from maskflownet_tpu.tools import submission as jax_submission

SINTEL_HW = sintel.SHAPE        # read_flo_dydx checks it
KITTI_HW = (20, 36)             # the readers resize; any size will do
HD1K_HW = (104, 206)            # larger than the default (50, 100) crop


def _equal(got, want):
    """Nested lists/tuples/dicts of arrays, equal in dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got == want


# ---------------------------------------------------------------------------
# PNG writers
# ---------------------------------------------------------------------------

def _chunk(typ, payload):
    return (struct.pack(">I", len(payload)) + typ + payload
            + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))


def _filtered_rows(body: np.ndarray, bpp: int, filters) -> bytes:
    """The scanlines of ``body`` (h, stride) uint8 filtered by
    ``filters[y % len(filters)]``, each prefixed with its filter byte."""
    h, stride = body.shape
    raw = body.astype(np.int32)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), raw[y, :-bpp]])
        b = raw[y - 1] if y else np.zeros(stride, np.int32)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][ft]
        rows.append(bytes([ft]) + ((raw[y] - pred) % 256).astype(
            np.uint8).tobytes())
    return b"".join(rows)


def write_png(path, body, w, depth, ctype, filters=(0,), interlace=0,
              idat_bytes=None):
    """A PNG of the filtered rows of ``body`` (h, stride) uint8, its IDAT
    split every ``idat_bytes`` bytes."""
    h = body.shape[0]
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    data = zlib.compress(_filtered_rows(body, bpp, filters))
    step = idat_bytes or len(data)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, interlace)))
        for i in range(0, len(data), step):
            fp.write(_chunk(b"IDAT", data[i:i + step]))
        fp.write(_chunk(b"IEND", b""))


def save_png(path, arr):
    """An 8-bit PNG written by PIL (mode from the array's shape)."""
    Image.fromarray(arr).save(path)


# ---------------------------------------------------------------------------
# dataset trees
# ---------------------------------------------------------------------------

def write_sintel_tree(root, rng, seqs=("alley_1", "ambush_2"), frames=3,
                      test_frames=3):
    """A Sintel tree at 436x1024: ``seqs`` x ``frames`` in training's
    clean and final with flow/ and invalid/, one test sequence of
    ``test_frames`` in final, and a split file labelling the first
    sequence 1 and the rest 2. Returns (root, split file)."""
    h, w = SINTEL_HW
    for seq in seqs:
        for subset in ("clean", "final"):
            d = os.path.join(root, "training", subset, seq)
            os.makedirs(d)
            for i in range(1, frames + 1):
                save_png(os.path.join(d, f"frame_{i:04d}.png"),
                         rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        for part in ("flow", "invalid"):
            os.makedirs(os.path.join(root, "training", part, seq))
        for i in range(1, frames):
            codecs.flo_save((rng.randn(h, w, 2) * 3).astype(np.float32),
                            os.path.join(root, "training", "flow", seq,
                                         f"frame_{i:04d}.flo"))
            save_png(os.path.join(root, "training", "invalid", seq,
                                  f"frame_{i:04d}.png"),
                     (rng.rand(h, w) < 0.1).astype(np.uint8) * 255)
    d = os.path.join(root, "test", "final", "market_1")
    os.makedirs(d)
    for i in range(1, test_frames + 1):
        save_png(os.path.join(d, f"frame_{i:04d}.png"),
                 rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    split = os.path.join(root, "split.txt")
    labels = [1 if k == 0 else 2 for k in range(len(seqs))
              for _ in range(frames - 1)]
    np.savetxt(split, np.array(labels), fmt="%d")
    return root, split


def _flow_occ(rng, hw):
    flow = (rng.randn(*hw, 2) * 5).astype(np.float32)
    enc = codecs.kitti_flow_encode(flow)
    enc[..., 2] = rng.rand(*hw) < 0.7
    return enc


def write_kitti_tree(root, rng, n_train=4, n_test=2, hw=KITTI_HW):
    """KITTI 2012 and 2015 trees: ``n_train`` training pairs with
    flow_occ, ``n_test`` testing pairs. Returns the paths dict."""
    path = kitti.default_paths(root)
    for key in path:
        os.makedirs(path[key])
    for ed in ("2012", "2015"):
        for k in range(n_train):
            for s in (10, 11):
                save_png(os.path.join(path[ed + "image"], f"{k:06d}_{s}.png"),
                         rng.randint(0, 256, (*hw, 3), dtype=np.uint8))
            codecs.png16_save(_flow_occ(rng, hw), os.path.join(
                path[ed + "flow_occ"], f"{k:06d}_10.png"))
        for k in range(n_test):
            for s in (10, 11):
                save_png(os.path.join(path[ed + "testing"],
                                      f"{k:06d}_{s}.png"),
                         rng.randint(0, 256, (*hw, 3), dtype=np.uint8))
    return path


def write_hd1k_tree(root, rng, seqs=(4, 3), hw=HD1K_HW):
    """HD1K: sequences of ``seqs`` frames each, images and flow_occ under
    the same names. Returns the paths dict."""
    path = hd1k.default_paths(root)
    for key in path:
        os.makedirs(path[key])
    for i, n in enumerate(seqs):
        for j in range(n):
            name = f"{i:06d}_{j:04d}.png"
            save_png(os.path.join(path["image"], name),
                     rng.randint(20, 200, (*hw, 3), dtype=np.uint8))
            codecs.png16_save(_flow_occ(rng, hw),
                              os.path.join(path["flow_occ"], name))
    return path


def write_things3d_tree(root, rng, n=2):
    """FlyingThings3D-subset, left camera: ``n`` into_future flows (540x960,
    as ``load`` checks), one into_past, and the images they name."""
    h, w = things3d.SHAPE
    img_dir = os.path.join(root, "train", "image_clean", "left")
    os.makedirs(img_dir)
    for i in range(n + 1):
        save_png(os.path.join(img_dir, f"{i:07d}.png"),
                 rng.randint(0, 256, (8, 12, 3), dtype=np.uint8))
    for orient, idx in (("into_future", range(n)), ("into_past", [n])):
        d = os.path.join(root, "train", "flow", "left", orient)
        os.makedirs(d)
        for i in idx:
            codecs.flo_save((rng.randn(h, w, 2) * 4).astype(np.float32),
                            os.path.join(d, f"{i:07d}.flo"))
    return root


# ---------------------------------------------------------------------------
# image_load
# ---------------------------------------------------------------------------

_MODES = {"1": (0, 1), "L": (0, 8), "LA": (4, 8), "RGB": (2, 8),
          "RGBA": (6, 8)}


@pytest.mark.parametrize("mode", list(_MODES))
def test_image_load_matches_jax_on_pil_files(tmp_path, mode):
    """PIL's own PNGs of every supported type, large enough that PIL
    writes several IDAT chunks (of 64 KiB) even at one bit a pixel."""
    rng = np.random.RandomState(1)
    arr = rng.randint(0, 256, (600, 900, 3), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    Image.fromarray(arr).convert(mode).save(p)
    with open(p, "rb") as fp:
        chunks = [t for t, _ in codecs._png_chunks(fp.read())]
    assert chunks.count(b"IDAT") > 1
    got = codecs.image_load(p)
    _equal(got, jax_codecs.image_load(p))
    if mode == "1":
        assert set(np.unique(got)) <= {0, 1}


@pytest.mark.parametrize("mode", list(_MODES))
def test_image_load_matches_jax_on_every_row_filter(tmp_path, mode):
    """Rows filtered None, Sub, Up, Average and Paeth in turn, written by
    hand at each type's pixel size (1-bit rows padded to a byte), the
    image data split over three IDAT chunks."""
    ctype, depth = _MODES[mode]
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    h, w = 11, 13
    stride = (w * channels * depth + 7) // 8
    body = np.random.RandomState(2).randint(0, 256, (h, stride),
                                            dtype=np.uint8)
    p = str(tmp_path / "f.png")
    write_png(p, body, w, depth, ctype, filters=(0, 1, 2, 3, 4),
              idat_bytes=64)
    got = codecs.image_load(p)
    _equal(got, jax_codecs.image_load(p))
    assert got.shape == (h, w, 2 if channels == 2 else 3)


@pytest.mark.parametrize("what", ["16-bit", "palette", "interlaced",
                                  "2-bit", "not a PNG"])
def test_image_load_refuses_what_it_cannot_decode(tmp_path, what):
    p = str(tmp_path / "x.png")
    body = np.zeros((4, 24), np.uint8)
    if what == "16-bit":
        Image.fromarray(np.arange(48, dtype=np.uint16).reshape(6, 8) * 999,
                        ).save(p)
    elif what == "palette":
        Image.fromarray(np.zeros((6, 8, 3), np.uint8)).convert("P").save(p)
    elif what == "interlaced":
        write_png(p, body, 8, 8, 2, interlace=1)
    elif what == "2-bit":
        write_png(p, body[:, :2], 8, 2, 0)
    else:
        with open(p, "wb") as fp:
            fp.write(b"P6 2 2 255\n" + bytes(12))
    with pytest.raises(ValueError):
        codecs.image_load(p)


# ---------------------------------------------------------------------------
# Sintel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sintel_tree(tmp_path_factory):
    return write_sintel_tree(str(tmp_path_factory.mktemp("sintel")),
                             np.random.RandomState(3))


def test_sintel_list_and_load_match_jax(sintel_tree):
    root, split = sintel_tree
    got = sintel.list_data(root, split)
    want = jax_sintel.list_data(root, split)
    _equal(got, want)
    assert [len(got[d]["clean"]) for d in ("training", "training1",
                                           "training2")] == [4, 2, 2]
    assert len(got["test"]["final"]) == 2
    for entry in got["training"]["final"][:2] + [got["test"]["final"][0]]:
        for path in entry:
            _equal(sintel.load.__wrapped__(path),
                   jax_sintel.load.__wrapped__(path))
    mask = sintel.load.__wrapped__(got["training"]["clean"][0][3])
    assert mask.shape == (*SINTEL_HW, 1) and mask.dtype == np.uint8


def test_sintel_split_order_guard_matches_jax(sintel_tree, tmp_path):
    """Mixed labels within a sequence: a warning from a small custom split,
    an error from an official-scale one, in both packages."""
    root, _ = sintel_tree
    small = str(tmp_path / "small.txt")
    np.savetxt(small, np.array([1, 2, 1, 2]), fmt="%d")
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        got = sintel.list_data(root, small)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = jax_sintel.list_data(root, small)
    _equal(got, want)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert len(ours) == 4           # two sequences, clean and final
    official = str(tmp_path / "official.txt")
    np.savetxt(official, np.tile([1, 2], 521)[:sintel.OFFICIAL_SINTEL_PAIRS],
               fmt="%d")
    errors = []
    for mod in (sintel, jax_sintel):
        with pytest.raises(ValueError) as e:
            mod.list_data(root, official)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# KITTI, HD1K, FlyingThings3D
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_paths(tmp_path_factory):
    return write_kitti_tree(str(tmp_path_factory.mktemp("kitti")),
                            np.random.RandomState(4))


@pytest.mark.parametrize("parts", ["train", "valid", "mixed"])
@pytest.mark.parametrize("resize", [None, (40, 16)])
def test_kitti_read_dataset_matches_jax(kitti_paths, parts, resize):
    kw = dict(path=kitti_paths, parts=parts, resize=resize)
    got = kitti.read_dataset(**kw)
    _equal(got, jax_kitti.read_dataset(**kw))
    # 4 flow files -> 3 pairs an edition; 2012's index 0 is validation
    assert len(got["flow"]) == {"train": 5, "valid": 1, "mixed": 6}[parts]


def test_kitti_crop_samples_and_testing_match_jax(kitti_paths):
    for kw in (dict(editions="2012", crop=(12, 30)),
               dict(editions="2015", samples=2, crop=(12, 30),
                    resize=(24, 10))):
        _equal(kitti.read_dataset(kitti_paths, **kw),
               jax_kitti.read_dataset(kitti_paths, **kw))
    assert kitti.VALIDATE_INDICES == jax_kitti.VALIDATE_INDICES
    assert kitti.default_paths("/r") == jax_kitti.default_paths("/r")
    for kw in (dict(), dict(editions="2015", resize=(24, 10))):
        got = kitti.read_dataset_testing(kitti_paths, **kw)
        _equal(got, jax_kitti.read_dataset_testing(kitti_paths, **kw))
    # (4 files - 1) // 2: one pair an edition, as the reference counts
    assert len(got["2015"]["image_0"]) == 1


@pytest.mark.parametrize("kw", [dict(), dict(parts="train", crop=(3, 5)),
                                dict(parts="valid"),
                                dict(resize=(30, 20), normalize=False,
                                     samples=5)])
def test_hd1k_read_dataset_matches_jax(tmp_path, kw):
    path = write_hd1k_tree(str(tmp_path), np.random.RandomState(5))
    got = hd1k.read_dataset(path, **kw)
    _equal(got, jax_hd1k.read_dataset(path, **kw))
    # "valid" gives nothing: its one index is taken for the first frame of
    # a sequence, since the skipped indices never set the previous one
    assert bool(got["flow"]) == (kw.get("parts") != "valid")


def test_things3d_list_and_load_match_jax(tmp_path):
    root = write_things3d_tree(str(tmp_path), np.random.RandomState(6))
    for sub_type in ("clean", "mixed"):
        _equal(things3d.list_data(root, sub_type),
               jax_things3d.list_data(root, sub_type))
    listing = things3d.list_data(root)
    assert len(listing["flow"]) == 3
    for col in ("image_0", "image_1", "flow"):
        got = things3d.load(listing[col][0])
        _equal(got, jax_things3d.load(listing[col][0]))
    assert got.dtype == np.float16 and got.shape == (*things3d.SHAPE, 2)
    assert things3d._cache_size() == jax_things3d._cache_size()


# ---------------------------------------------------------------------------
# host-side geometric augmentation
# ---------------------------------------------------------------------------

def _geo_configs(dataset, target, orig):
    ours = presets.geometry_aug_config(dataset, target, orig)
    fields = {k: getattr(ours, k) for k in GeometryAugConfig.__dataclass_fields__}
    return ours, JaxGeometryAugConfig(**fields)


@pytest.mark.parametrize("dataset", ["chairs", "sintel", "kitti"])
def test_host_geometry_matches_jax_numpy_path(monkeypatch, dataset):
    """One sample and a batch from one RandomState each: outputs within
    1e-5, the draws equal (the states after them equal). The JAX module is
    held on its numpy warp (OpenCV interpolates in fixed point)."""
    monkeypatch.setattr(jax_host_geometry, "_HAS_CV2", False)
    rng = np.random.RandomState(7)
    b, orig, target = 2, (40, 56), (32, 48)
    img1 = rng.randint(0, 256, (b, *orig, 3)).astype(np.float32)
    img2 = rng.randint(0, 256, (b, *orig, 3)).astype(np.float32)
    flow = (rng.randn(b, *orig, 2) * 3).astype(np.float32)
    mask = (rng.rand(b, *orig, 1) < 0.8).astype(np.float32)
    ours_cfg, jax_cfg = _geo_configs(dataset, target, orig)
    for fn, args in (("host_geometry_augmentation",
                      (img1[0], img2[0], flow[0], mask[0])),
                     ("batch_host_geometry", (img1, img2, flow, None)),
                     ("batch_host_geometry", (img1, img2, flow, mask))):
        r_ours, r_jax = np.random.RandomState(8), np.random.RandomState(8)
        got = getattr(host_geometry, fn)(r_ours, *args, ours_cfg)
        want = getattr(jax_host_geometry, fn)(r_jax, *args, jax_cfg)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        assert got[0].shape[-3:-1] == target
        assert r_ours.randint(1 << 30) == r_jax.randint(1 << 30)


# ---------------------------------------------------------------------------
# flow colouring and submission files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 2.5])
def test_flow_to_color_matches_jax(clip):
    flow = (np.random.RandomState(9).randn(17, 23, 2) * 4).astype(np.float32)
    flow[0, 0] = 0
    _equal(flow_vis.flow_to_color(flow, clip),
           jax_flow_vis.flow_to_color(flow, clip))


class StubTrainer:
    """``Trainer.predict``'s signature; flows drawn from each pair's shape
    and position, the same in every call."""

    def __init__(self):
        self.calls = []

    def predict(self, img1s, img2s, batch_size=4, resize=None):
        self.calls.append((len(img1s), batch_size, resize))
        for k, img in enumerate(img1s):
            rng = np.random.RandomState(k)
            flow = (rng.randn(*img.shape[:2], 2) * 10).astype(np.float32)
            yield flow, None, None


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fp:
                out[os.path.relpath(os.path.join(d, f), root)] = fp.read()
    return out


def test_submission_files_match_jax_byte_for_byte(sintel_tree, kitti_paths,
                                                  tmp_path, monkeypatch):
    root, split = sintel_tree
    monkeypatch.setenv("MFN_SINTEL_ROOT", root)
    monkeypatch.setenv("MFN_SINTEL_SPLIT", split)
    monkeypatch.setenv("MFN_KITTI_ROOT",
                       os.path.dirname(os.path.dirname(os.path.dirname(
                           kitti_paths["2012image"]))))
    outs = []
    for name, mod in (("port", submission), ("jax", jax_submission)):
        stub = StubTrainer()
        mod.predict_sintel(stub, str(tmp_path / name), batch_size=3)
        mod.predict_kitti(stub, str(tmp_path / name), batch_size=3,
                          resize=(64, 128))
        outs.append((_tree_bytes(str(tmp_path / name)), stub.calls))
    assert outs[0] == outs[1]
    files = sorted(outs[0][0])
    assert files == ["final/market_1/frame_0001.flo",
                     "final/market_1/frame_0002.flo",
                     "kitti_2012/000000_10.png", "kitti_2015/000000_10.png"]
    assert outs[0][1] == [(2, 3, (448, 1024)), (1, 3, (64, 128)),
                          (1, 3, (64, 128))]
