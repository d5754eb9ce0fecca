"""The port's inference and evaluation tools (``maskflownet_torch/tools/
infer.py``, ``parity_eval.py``) and its PNG writer against the JAX
package's tools, on the CPU.

Each package's ``load_trainer`` is replaced by the same stub trainer (a
fixed flow, occlusion and warped image; metrics computed in numpy from the
frames the readers give it), so the files written and the summaries
printed are compared with no model in the way: the ``.flo`` files byte for
byte, the PNGs once decoded, the summaries and exit codes equal. Video IO
runs against one stub ``cv2`` module. One real ``parity_eval.run`` of the
port (a seeded checkpoint, as ``.params`` and as ``.npz``) is held against
``Trainer.validate``. No JAX program is compiled."""

import json
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

import maskflownet_tpu.tools.infer as jax_infer
import maskflownet_tpu.tools.parity_eval as jax_parity
from maskflownet_torch.data import codecs, kitti, sintel
from maskflownet_torch.tools import flow_vis, import_mxnet, infer, parity_eval
from maskflownet_torch.training import Trainer, TrainSettings
from test_torch_import_mxnet import gluon_checkpoint
from test_torch_readers import write_kitti_tree

SINTEL_HW = (64, 128)           # the readers' Sintel size, patched below
KITTI_HW = (64, 128)
KITTI_RESIZE = (128, 64)        # (width, height), a multiple of 64


# ---------------------------------------------------------------------------
# png8_save
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 13), (5, 11, 3), (1, 1), (3, 1, 3)])
def test_png8_save_decodes_to_the_array(tmp_path, shape):
    arr = np.random.RandomState(0).randint(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    codecs.png8_save(arr, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    want = arr if arr.ndim == 3 else np.repeat(arr[..., None], 3, 2)
    got = codecs.image_load(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png8_save_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        codecs.png8_save(np.zeros((2, 3), np.uint16), str(tmp_path / "x.png"))


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------

class StubPredictor:
    """``Trainer.predict``'s signature: a seeded flow, occlusion and warped
    image (partly outside [0, 1]) for each pair; records its calls."""

    def __init__(self):
        self.calls = []

    def predict(self, img1s, img2s, batch_size=4, resize=None):
        self.calls.append((len(img1s), batch_size, resize))
        for i, img in enumerate(img1s):
            h, w = img.shape[:2]
            r = np.random.RandomState(i)
            yield ((r.randn(h, w, 2) * 5).astype(np.float32),
                   r.rand(h, w, 1).astype(np.float32),
                   (r.rand(h, w, 3) * 1.4 - 0.2).astype(np.float32))


def _run_infer(monkeypatch, tmp_path, argv):
    """Both packages' ``infer.main`` on ``argv`` + ``-o`` a directory each,
    stub trainers in place of the checkpoint; returns the directories and
    the stubs."""
    out = {}
    for name, module in (("jax", jax_infer), ("port", infer)):
        stub = StubPredictor()
        monkeypatch.setattr(module, "load_trainer",
                            lambda *a, _s=stub, **k: _s)
        d = str(tmp_path / name)
        assert module.main(["MaskFlownet_S.yaml", "-c", "ck.npz", *argv,
                            "-o", d]) == 0
        out[name] = (d, stub)
    return out


def _same_png(a, b):
    pa, pb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
    assert pa.dtype == pb.dtype == np.uint8
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(codecs.image_load(a), codecs.image_load(b))


def test_infer_image_pair_writes_the_jax_tools_files(monkeypatch, tmp_path):
    rng = np.random.RandomState(1)
    pair = []
    for k in range(2):
        pair.append(str(tmp_path / f"im{k}.png"))
        Image.fromarray(rng.randint(0, 256, (30, 45, 3), dtype=np.uint8)
                        ).save(pair[-1])
    runs = _run_infer(monkeypatch, tmp_path, ["-i", *pair, "--resize",
                                              "64,64"])
    (jd, jstub), (pd, pstub) = runs["jax"], runs["port"]
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
        "flow.flo", "flow.png", "warped.png"]
    with open(os.path.join(pd, "flow.flo"), "rb") as a, \
            open(os.path.join(jd, "flow.flo"), "rb") as b:
        assert a.read() == b.read()
    for name in ("flow.png", "warped.png"):
        _same_png(os.path.join(pd, name), os.path.join(jd, name))
    flow, _, warped = next(StubPredictor().predict([np.zeros((30, 45, 3))],
                                                   [None]))
    np.testing.assert_array_equal(codecs.flo_load(os.path.join(
        pd, "flow.flo")), flow[..., ::-1])
    np.testing.assert_array_equal(codecs.image_load(os.path.join(
        pd, "flow.png")), flow_vis.flow_to_color(flow))
    np.testing.assert_array_equal(codecs.image_load(os.path.join(
        pd, "warped.png")), (np.clip(warped, 0, 1) * 255).astype(np.uint8))
    assert pstub.calls == jstub.calls == [(1, 1, (64, 64))]


def test_infer_frames_writes_the_jax_tools_files(monkeypatch, tmp_path):
    rng = np.random.RandomState(2)
    frames = tmp_path / "frames"
    frames.mkdir()
    for k in range(5):
        Image.fromarray(rng.randint(0, 256, (21, 33, 3), dtype=np.uint8)
                        ).save(str(frames / f"f{k:02d}.png"))
    runs = _run_infer(monkeypatch, tmp_path, ["--frames", str(frames)])
    (jd, jstub), (pd, pstub) = runs["jax"], runs["port"]
    names = [f"f{k:02d}_flow.png" for k in range(4)]
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == names
    for name in names:
        _same_png(os.path.join(pd, name), os.path.join(jd, name))
    assert pstub.calls == jstub.calls == [(4, 4, None)]


def test_infer_frames_takes_the_batch_flag(monkeypatch, tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    for k in range(3):
        codecs.png8_save(np.full((8, 8, 3), k, np.uint8),
                         str(frames / f"{k}.png"))
    stub = StubPredictor()
    monkeypatch.setattr(infer, "load_trainer", lambda *a, **k: stub)
    assert infer.main(["MaskFlownet_S.yaml", "-c", "ck.npz", "--frames",
                       str(frames), "--batch", "2", "-o",
                       str(tmp_path / "o")]) == 0
    assert stub.calls == [(2, 2, None)]


def _stub_cv2(videos, fps, written):
    """A ``cv2`` module of the calls the tools make: ``VideoCapture`` over
    ``videos`` (path -> BGR frames), ``VideoWriter`` recording into
    ``written``."""
    cv2 = types.ModuleType("cv2")
    cv2.CAP_PROP_FPS = 5

    class VideoCapture:
        def __init__(self, path):
            self.frames = list(videos.get(path, []))
            self.opened = path in videos

        def isOpened(self):
            return self.opened

        def get(self, prop):
            assert prop == cv2.CAP_PROP_FPS
            return fps

        def read(self):
            return (True, self.frames.pop(0)) if self.frames else (False,
                                                                   None)

        def release(self):
            pass

    class VideoWriter:
        def __init__(self, path, fourcc, fps_, size):
            self.rec = written[path] = {"fourcc": fourcc, "fps": fps_,
                                        "size": size, "frames": []}

        def isOpened(self):
            return True

        def write(self, frame):
            self.rec["frames"].append(np.array(frame))

        def release(self):
            pass

    cv2.VideoCapture, cv2.VideoWriter = VideoCapture, VideoWriter
    cv2.VideoWriter_fourcc = lambda *c: "".join(c)
    return cv2


def test_video_io_matches_the_jax_tool_on_one_cv2(monkeypatch):
    rng = np.random.RandomState(3)
    bgr = [rng.randint(0, 256, (12, 20, 3), dtype=np.uint8) for _ in range(4)]
    got = {}
    for name, module in (("jax", jax_infer), ("port", infer)):
        written = {}
        monkeypatch.setitem(sys.modules, "cv2",
                            _stub_cv2({"in.mp4": bgr}, 12.5, written))
        frames, fps = module.read_video("in.mp4")
        assert fps == 12.5 and len(frames) == 4
        for f, b in zip(frames, bgr):
            np.testing.assert_array_equal(f, b[..., ::-1])   # BGR -> RGB
        module.write_video("rt.avi", frames, fps)
        n = module.predict_video_flow(StubPredictor(), "in.mp4", "out.mp4",
                                      batch_size=2)
        assert n == 3
        assert written["rt.avi"]["fourcc"] == "MJPG"
        assert written["out.mp4"]["fourcc"] == "mp4v"
        assert written["rt.avi"]["size"] == (20, 12)
        for f, b in zip(written["rt.avi"]["frames"], bgr):
            np.testing.assert_array_equal(f, b)               # RGB -> BGR
        with pytest.raises(IOError, match="cannot open"):
            module.read_video("missing.mp4")
        got[name] = written
    assert got["port"].keys() == got["jax"].keys()
    for path, rec in got["jax"].items():
        mine = got["port"][path]
        assert (mine["fourcc"], mine["fps"], mine["size"]) == (
            rec["fourcc"], rec["fps"], rec["size"])
        assert len(mine["frames"]) == len(rec["frames"])
        for a, b in zip(mine["frames"], rec["frames"]):
            np.testing.assert_array_equal(a, b)


def test_video_without_opencv_raises_and_names_frames(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    with pytest.raises(ImportError, match="--frames"):
        infer.read_video("in.mp4")
    with pytest.raises(ImportError, match="--frames"):
        infer.write_video("out.mp4", [np.zeros((2, 2, 3), np.uint8)], 1.0)

    def no_model(*a, **k):
        raise AssertionError("the model was built before OpenCV was needed")

    monkeypatch.setattr(infer, "load_trainer", no_model)
    with pytest.raises(ImportError, match="--frames"):
        infer.main(["MaskFlownet_S.yaml", "-c", "ck.npz", "--video",
                    "in.mp4", "out.mp4"])


# ---------------------------------------------------------------------------
# parity_eval
# ---------------------------------------------------------------------------

def write_sintel_tree(root, rng, frames=3):
    """Sintel training at SINTEL_HW: alley_1 (split 1) and ambush_2 (split
    2) in clean and final, flow and invalid masks. Returns the split file."""
    h, w = SINTEL_HW
    for seq in ("alley_1", "ambush_2"):
        for part in ("clean", "final", "flow", "invalid"):
            os.makedirs(os.path.join(root, "training", part, seq))
        for i in range(1, frames + 1):
            for part in ("clean", "final"):
                codecs.png8_save(rng.randint(0, 256, (h, w, 3),
                                             dtype=np.uint8),
                                 os.path.join(root, "training", part, seq,
                                              f"frame_{i:04d}.png"))
            if i < frames:
                codecs.flo_save((rng.randn(h, w, 2) * 2).astype(np.float32),
                                os.path.join(root, "training", "flow", seq,
                                             f"frame_{i:04d}.flo"))
                codecs.png8_save((rng.rand(h, w) < 0.2).astype(np.uint8)
                                 * 255, os.path.join(
                                     root, "training", "invalid", seq,
                                     f"frame_{i:04d}.png"))
    split = os.path.join(root, "split.txt")
    with open(split, "w") as fp:
        fp.write("1\n" * (frames - 1) + "2\n" * (frames - 1))
    return split


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(5)
    split = write_sintel_tree(str(root / "sintel"), rng)
    write_kitti_tree(str(root / "kitti"), rng, n_train=3, n_test=0,
                     hw=KITTI_HW)
    return {"sintel_root": str(root / "sintel"), "sintel_split": split,
            "kitti_root": str(root / "kitti")}


@pytest.fixture(autouse=True)
def sintel_shape(monkeypatch):
    """Both packages' Sintel readers check the flow's size: the trees' here."""
    monkeypatch.setattr("maskflownet_torch.data.sintel.SHAPE", SINTEL_HW)
    monkeypatch.setattr("maskflownet_tpu.data.sintel.SHAPE", SINTEL_HW)


class StubValidator:
    """``Trainer.validate``'s signature: bounded metrics computed in numpy
    from what the readers hand it, so equal inputs give equal numbers."""

    def validate(self, img1s, img2s, flows, masks=None, batch_size=4,
                 resize=None, return_type="epe"):
        epe = (np.mean([np.tanh(np.abs(f)).mean() for f in flows])
               + np.mean([a.mean() for a in img1s]) / 255
               + np.mean([b.mean() for b in img2s]) / 255)
        fl = np.mean([m.mean() for m in masks]) / 255
        return {"epe": float(epe), "kitti": float(fl),
                "both": (float(epe), float(fl))}[return_type]


STATUS_CASES = {
    # name: (main's flags, status, exit code)
    "pass": (["--expect", "dbbSep30", "--bound", "1e6"], "pass", 0),
    "fail": (["--expect", "abbSep15", "--bound", "0"], "fail", 1),
    "computed": (["--expect", "none", "--network", "MaskFlownet_S"],
                 "computed", 0),
    "no-data": (["--expect", "5adNov03"], "no-data", 2),
}


@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_parity_eval_summaries_and_exit_codes_match_jax(monkeypatch, capsys,
                                                        trees, tmp_path,
                                                        case):
    """Both packages' ``main``: the same table, summary line and exit
    code for each status."""
    flags, status, rc = STATUS_CASES[case]
    roots = dict(trees) if case != "no-data" else {
        "sintel_root": str(tmp_path / "none"),
        "sintel_split": str(tmp_path / "none.txt"),
        "kitti_root": str(tmp_path / "none")}
    argv = [str(tmp_path / "ck.npz"), *flags, "--batch", "2",
            *(f"--{k}={v}" for k, v in roots.items())]
    printed, rcs = {}, {}
    for name, module in (("jax", jax_parity), ("port", parity_eval)):
        monkeypatch.setattr(module, "load_trainer",
                            lambda *a, **k: StubValidator())
        rcs[name] = module.main(argv)
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert rcs["port"] == rcs["jax"] == rc
    (summary,) = [json.loads(line) for line in printed["port"].splitlines()
                  if line.startswith("{")]
    assert summary["status"] == status
    if case == "no-data":
        assert summary["skipped"] == ["kitti.2012", "kitti.2015",
                                      "sintel.val"]
    elif case == "computed":
        assert len(summary["results"]) == 8 and not summary["skipped"]
    else:
        assert len(summary["verdicts"]) == {"pass": 6, "fail": 8}[case]


def test_parity_eval_skips_an_absent_root(monkeypatch, trees, tmp_path):
    got = {}
    for module in (jax_parity, parity_eval):
        monkeypatch.setattr(module, "load_trainer",
                            lambda *a, **k: StubValidator())
        got[module] = module.run("ck.npz", expect="dbbSep30", bound=1e6,
                                 sintel_root=trees["sintel_root"],
                                 sintel_split=trees["sintel_split"],
                                 kitti_root=str(tmp_path / "none"))
    assert got[parity_eval] == got[jax_parity]
    assert got[parity_eval]["skipped"] == ["kitti.2012", "kitti.2015"]
    assert got[parity_eval]["status"] == "pass"


def test_parity_eval_on_the_cpu_is_trainer_validate(trees):
    """The real port harness on the CPU, f32: a seeded checkpoint read as
    a Gluon ``.params`` file (through the importer) and as the ``.npz`` the
    importer writes give the same table, equal to ``Trainer.validate`` on
    the readers' arrays."""
    d = os.path.dirname(trees["sintel_root"])
    src, npz = os.path.join(d, "ck.params"), os.path.join(d, "ck.npz")
    import_mxnet.write_mxnet_params(src, {
        k: v * 0.5 for k, v in gluon_checkpoint("MaskFlownet_S").items()})
    try:
        assert import_mxnet.main([src, npz]) == 0
        summaries = [parity_eval.run(path, batch_size=1, samples=1,
                                     kitti_resize=KITTI_RESIZE, device="cpu",
                                     **trees) for path in (src, npz)]
        trainer = Trainer(TrainSettings(compute_dtype="float32"),
                          device="cpu")
        trainer.load(npz, load_states=False)
    finally:
        for path in (src, npz):
            if os.path.exists(path):
                os.remove(path)
    assert summaries[0]["results"] == summaries[1]["results"]
    got = summaries[0]
    assert got["status"] == "computed" and got["network"] == "MaskFlownet_S"
    want = {}
    listed = sintel.list_data(trees["sintel_root"], trees["sintel_split"])
    for row, division in (("sintel.trainval", "training"),
                          ("sintel.val", "training2")):
        for subset in ("clean", "final"):
            cols = [[sintel.load(p) for p in col]
                    for col in zip(*listed[division][subset][:1])]
            want[f"{row}.{subset}"] = trainer.validate(*cols, batch_size=1)
    for ed in ("2012", "2015"):
        ds = kitti.read_dataset(kitti.default_paths(trees["kitti_root"]),
                                editions=ed, parts="mixed",
                                resize=KITTI_RESIZE, samples=1)
        want[f"kitti.{ed}.epe"], want[f"kitti.{ed}.fl"] = trainer.validate(
            ds["image_0"], ds["image_1"], ds["flow"], ds["occ"],
            batch_size=1, return_type="both")
    assert got["results"] == want
    assert all(np.isfinite(v) for v in want.values())
