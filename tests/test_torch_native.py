"""The port's host-side C++ runtime (``maskflownet_torch/native/``) on the
CPU: ``png_unfilter`` bitwise against the port's numpy unfilter
(``codecs._unfilter``) and the JAX package's (``_unfilter_py``) on random
filtered rows, every filter id and bit widths of 1-8 bytes a pixel;
filter 5 refused; the build into ``build/maskflownet_torch/`` (nothing
under ``maskflownet_tpu/`` touched), its refusal with the compiler's
output, and the readers' use of the library with no numpy fallback. No JAX function is compiled."""

import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from maskflownet_torch import native
from maskflownet_torch.data import codecs
from maskflownet_tpu.data.codecs import _unfilter_py as jax_unfilter
from test_torch_readers import _chunk, _filtered_rows, write_png

ROOT = Path(__file__).resolve().parents[1]
BPPS = (1, 2, 3, 4, 6, 8)
FILTERS = ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 2, 1))


def _filtered(body, bpp, filters):
    """The filter bytes and the filtered body of ``_filtered_rows``."""
    h, stride = body.shape
    rows = np.frombuffer(_filtered_rows(body, bpp, filters), np.uint8)
    rows = rows.reshape(h, stride + 1)
    return rows[:, 0].copy(), rows[:, 1:].copy()


@pytest.mark.parametrize("filters", FILTERS, ids=str)
@pytest.mark.parametrize("bpp", BPPS)
def test_unfilter_is_bitwise_the_plain_and_jax_unfilters(bpp, filters):
    rng = np.random.RandomState(bpp * 10 + len(filters))
    body = rng.randint(0, 256, (9, bpp * 11)).astype(np.uint8)
    ft, raw = _filtered(body, bpp, filters)
    got = raw.copy()
    native.png_unfilter(got, ft, bpp)
    np.testing.assert_array_equal(got, body)
    np.testing.assert_array_equal(codecs._unfilter(raw, ft, bpp), body)
    np.testing.assert_array_equal(jax_unfilter(raw, ft, bpp), body)


def test_unfilter_refuses_filter_5():
    raw = np.zeros((3, 6), np.uint8)
    with pytest.raises(ValueError, match="unknown PNG filter 5"):
        native.png_unfilter(raw, np.array([0, 5, 1], np.uint8), 3)
    with pytest.raises(ValueError, match="unknown PNG filter 5"):
        codecs._unfilter(raw, np.array([0, 5, 1], np.uint8), 3)


def test_png_read_refuses_filter_5(tmp_path):
    """An RGB PNG whose row 2 carries filter byte 5."""
    rows = bytearray(_filtered_rows(np.zeros((4, 12), np.uint8), 3, (1,)))
    rows[2 * 13] = 5
    with open(tmp_path / "bad.png", "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0,
                                             0)))
        fp.write(_chunk(b"IDAT", zlib.compress(bytes(rows))))
        fp.write(_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown PNG filter 5"):
        codecs.image_load(str(tmp_path / "bad.png"))


def _tree_state(root: Path):
    return sorted((str(p.relative_to(root)), p.stat().st_size,
                   p.stat().st_mtime_ns) for p in root.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def test_library_builds_under_build_and_touches_nothing_of_jax(tmp_path):
    assert native.library_path().parent == ROOT / "build" / \
        "maskflownet_torch"
    assert native.SOURCE == ROOT / "maskflownet_torch" / "native" / \
        "png_filters.cpp"
    before = _tree_state(ROOT / "maskflownet_tpu")
    so = native.build(build_dir=tmp_path)          # a fresh g++ build
    assert so.parent == tmp_path and so.exists()
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    assert native.load() is native.load()
    assert native.library_path().exists()
    assert _tree_state(ROOT / "maskflownet_tpu") == before


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int png_unfilter( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(source=bad, build_dir=tmp_path / "out")
    assert "error" in str(err.value)
    assert not any((tmp_path / "out").iterdir())
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(build_dir=tmp_path / "none")


def test_readers_take_the_library_with_no_fallback(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    write_png(tmp_path / "a.png", img.reshape(5, 21), 7, 8, 2,
              filters=(0, 1, 2, 3, 4))
    # the numpy unfilter is not on the path
    monkeypatch.setattr(codecs, "_unfilter", None)
    np.testing.assert_array_equal(codecs.image_load(str(tmp_path / "a.png")),
                                  img)

    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="no library"):
        codecs.image_load(str(tmp_path / "a.png"))
    assert os.path.exists(native.SOURCE)
