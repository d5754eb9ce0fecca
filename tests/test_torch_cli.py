"""The port's training CLI and what it reads, against the JAX package's:
the config reader (so ``yaml.safe_load``) on every stock YAML and on each
scalar form, ``parse_args``, ``build_settings`` for every network x
dataset config, ``load_training_data`` on tiny trees for each dataset
branch, and ``training/logging``. Then the CLI end to end on the CPU
(``--device cpu --compute_dtype float32``, 64x64 crops from 96x128
sources, batch 2, 3 steps): an S run with host geometry, its resume, a
run through the device cache, the cascade from the S run with
``--clear_steps``, and ``--valid`` and ``--predict`` with the S run's
checkpoint (the only one the module writes). No JAX model is built,
compiled or trained: the CLI's steps are the port's ``Trainer``, which
``tests/test_torch_training.py`` and ``tests/test_torch_input.py`` hold
against the JAX step."""

import datetime
import math
import os
import shutil
import threading

import numpy as np
import pytest
import torch
import yaml

import maskflownet_tpu.cli.main as jax_cli
import maskflownet_tpu.training.logging as jax_logging
import maskflownet_torch.cli.main as cli
import maskflownet_torch.training.logging as logging
from maskflownet_torch import interop
from maskflownet_torch.config import CONFIG_DIR, load_config, yaml_subset
from maskflownet_torch.data import codecs, kitti, sintel, things3d
from maskflownet_torch.models import HEAD_SCOPE, param_shapes
from maskflownet_torch.training import TrainSettings, Trainer
from maskflownet_tpu.config import CONFIG_DIR as JAX_CONFIG_DIR
from maskflownet_tpu.config import load_config as jax_load_config
from maskflownet_tpu.data import things3d as jax_things3d
from test_torch_readers import (_equal, write_hd1k_tree, write_kitti_tree,
                                write_sintel_tree, write_things3d_tree)

NETWORKS = sorted(f for f in os.listdir(JAX_CONFIG_DIR)
                  if f.startswith("MaskFlownet"))
DATASETS = sorted(f for f in os.listdir(JAX_CONFIG_DIR)
                  if f.endswith(".yaml") and f not in NETWORKS)
B, SRC, CROP, STEPS = 2, (96, 128), (64, 64), 3
RESIZE = "64,128"


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_the_stock_yamls_are_the_jax_packages_byte_for_byte():
    ours = sorted(f for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml"))
    assert ours == sorted(NETWORKS + DATASETS) and len(ours) == 13
    for f in ours:
        with open(os.path.join(CONFIG_DIR, f), "rb") as a, \
                open(os.path.join(JAX_CONFIG_DIR, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("name", NETWORKS + DATASETS)
def test_load_config_matches_jax_on_the_stock_yamls(name):
    got, want = load_config(name), jax_load_config(name)
    assert got.value == want.value and got.value is not None
    assert got.optimizer.learning_rate.value == \
        want.optimizer.learning_rate.value


# each accepted scalar form, as the stock files and users write them
SCALARS = """\
# a comment
lr_dot: 5.0e-5
lr_nodot: 1e-4          # a string under YAML 1.1
exp_unsigned: 1.0e4     # a string too
exp_plus: 1.5E+3
tiny: 0.75e-5
lead_dot: .5
trail_dot: 1.
neg_lead_dot: -.5e-3
int: 42
neg: -7
plus: +3
zero: 0
under: 1_000
octal: 010
not_octal: 09
hex: 0x1f
binary: 0b101
inf: .inf
neg_inf: -.INF
t: true
T: True
yes_: yes
on_: on
Off_: Off
n: n
tilde: ~
null_: null
Null_: Null
empty:
word: MaskFlownet_S
url: http://host/x
hash: a#b
spaced: a b c
1: int key
no: bool key
"""
STRUCTURES = """\
network:
  class: MaskFlownet
  upfeat_ch: [16, 16, 16, 16]
  nested:
    deeper: [1, [2, 3.5], [], x]
optimizer:
  q: 0.4
  learning_rate:
    - [300000, 1.0e-4]
    - [500000, 5.0e-5]
seq_same_indent:
- 1
- [2, 3,]
-
dup: 1
dup: 2
"""


@pytest.mark.parametrize("text", [SCALARS, STRUCTURES, "", "# only\n",
                                  "- [1, 2]\n- 3\n", "word\n", "  a: 1\n"],
                         ids=["scalars", "structures", "empty", "comment",
                              "top_sequence", "top_scalar", "indented"])
def test_load_config_matches_yaml_safe_load(tmp_path, text):
    p = tmp_path / "c.yaml"
    p.write_text(text)
    want = yaml.safe_load(text)
    assert jax_load_config(str(p)).value == want
    assert load_config(str(p)).value == want
    if text is SCALARS:
        got = load_config(str(p)).value
        assert got["lr_dot"] == 5e-5 and got["lr_nodot"] == "1e-4"
        assert got["octal"] == 8 and got["yes_"] is True
        assert got["tilde"] is None and got[1] == "int key"


def test_nan_reads_as_nan(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: .nan\nb: [.NaN]\n")
    for got in (load_config(str(p)).value, yaml.safe_load(p.read_text())):
        assert math.isnan(got["a"]) and math.isnan(got["b"][0])


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: 'quoted'\n",
    "a: \"quoted\"\n", "'k': 1\n", "a: |\n  block\n", "a: >\n  folded\n",
    "a: {b: 1}\n", "---\na: 1\n", "a: 1\n---\nb: 2\n", "%YAML 1.1\na: 1\n",
    "? a\n: b\n", "- a: 1\n", "a: plain\n  continued\n", "a:\n\t- 1\n",
    "a: 2001-12-14\n", "a: 1:30\n", "<<: x\n", "a: [1,\n 2]\n",
    "a: b: c\n", "a: 1\n  b: 2\n", "a:\n  b: 1\n c: 2\n", "- - 1\n",
    "a: [1, {b: 2}]\n", "a: =\n"])
def test_constructs_outside_the_subset_raise(tmp_path, text):
    p = tmp_path / "c.yaml"
    p.write_text(text)
    with pytest.raises(yaml_subset.YAMLSubsetError, match="line"):
        load_config(str(p))


def test_reader_defaults_print_as_in_jax(capsys):
    for mod in (load_config, jax_load_config):
        r = mod("chairs.yaml")
        assert r.optimizer.learning_rate.get(None) is None
        assert r.dataset.get("x") == "chairs" and r["dataset"].value == \
            "chairs"
    out = capsys.readouterr().out.splitlines()
    assert out == ["Default FLAGS.optimizer.learning_rate to None"] * 2


# ---------------------------------------------------------------------------
# parse_args, build_settings
# ---------------------------------------------------------------------------

ARGVS = [[], ["MaskFlownet_S.yaml"],
         ["MaskFlownet.yaml", "--dataset_cfg", "sintel.yaml", "-b", "4",
          "-c", "abc:100", "--clear_steps", "--debug", "--resize",
          "448,1024", "--root", "/r", "--compute_dtype", "float32",
          "--profile", "5,6", "-s", "2", "-n", "MaskFlownet_S"],
         ["MaskFlownet_S.yaml", "--device_cache", "8"],
         ["MaskFlownet_S.yaml", "--device_cache", "8", "--aug", "host"],
         ["MaskFlownet_S.yaml", "--aug", "device", "--valid"],
         ["MaskFlownet_S.yaml", "--predict", "--aug", "auto"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv):
    got = vars(cli.parse_args(argv))
    want = vars(jax_cli.parse_args(argv))
    assert got.pop("device") == "cuda" and want.pop("platform") is None
    # the port's flags for the JAX package's MFN_AUG_SAMPLER and
    # MFN_AUG_LABEL_DTYPE, at its off-TPU defaults
    assert (got.pop("aug_sampler"), got.pop("aug_label_dtype")) == (
        "affine", "float16")
    assert got == want
    assert cli.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def _fields(obj):
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("network", NETWORKS)
def test_build_settings_matches_jax(network, dataset):
    cfgs = [(load_config(network), load_config(dataset)),
            (jax_load_config(network), jax_load_config(dataset))]
    for aug in ("host", "device"):
        argv = [network, "--aug", aug, "--compute_dtype", "float32"]
        got, got_geo = cli.build_settings(cli.parse_args(argv), *cfgs[0])
        want, want_geo = jax_cli.build_settings(jax_cli.parse_args(argv),
                                                *cfgs[1])
        g, w = _fields(got), _fields(want)
        # the port's explicit counterparts of MFN_AUG_SAMPLER and
        # MFN_AUG_LABEL_DTYPE, at the JAX package's off-TPU defaults
        assert (g.pop("aug_sampler"), g.pop("aug_label_dtype")) == (
            "affine", "float16")
        assert set(g) == set(w)
        for k in g:
            if k == "model_cfg":
                assert {f: getattr(w[k], f) for f in _fields(g[k])
                        if f != "deform"} == {
                    f: v for f, v in _fields(g[k]).items() if f != "deform"}
                assert g[k].deform == "auto"
            elif k in ("geo", "color"):
                assert (g[k] is None) == (w[k] is None)
                if g[k] is not None:
                    assert _fields(g[k]) == {f: getattr(w[k], f)
                                             for f in _fields(g[k])}
            else:
                assert g[k] == w[k], k
        assert _fields(got_geo) == {f: getattr(want_geo, f)
                                    for f in _fields(got_geo)}
        assert (got.geo is None) == (aug == "host")


@pytest.mark.parametrize("label_dtype", ["float16", "float32"])
def test_aug_sampler_flags_reach_the_settings(label_dtype):
    """``--aug_sampler twopass`` and ``--aug_label_dtype`` become the
    settings' ``aug_sampler``/``aug_label_dtype``; twopass without device
    augmentation is refused."""
    cfgs = (load_config("MaskFlownet_S.yaml"), load_config("chairs.yaml"))
    argv = ["MaskFlownet_S.yaml", "--aug_sampler", "twopass",
            "--aug_label_dtype", label_dtype]
    got, _ = cli.build_settings(cli.parse_args(argv + ["--aug", "device"]),
                                *cfgs)
    assert (got.aug_sampler, got.aug_label_dtype) == ("twopass", label_dtype)
    assert got.geo is not None
    with pytest.raises(ValueError, match="--aug device"):
        cli.build_settings(cli.parse_args(argv), *cfgs)


# ---------------------------------------------------------------------------
# dataset trees, and load_training_data
# ---------------------------------------------------------------------------

def write_chairs_tree(root, rng, n=6):
    """``n`` FlyingChairs pairs at 384x512, the last two for validation."""
    os.makedirs(root)
    for i in range(1, n + 1):
        for j in (1, 2):
            img = rng.randint(0, 256, (384, 512, 3), dtype=np.uint8)
            with open(os.path.join(root, "%05d_img%d.ppm" % (i, j)),
                      "wb") as fp:
                fp.write(b"P6 512 384 255\n" + img.tobytes())
        codecs.flo_save((rng.randn(384, 512, 2) * 3).astype(np.float32),
                        os.path.join(root, "%05d_flow.flo" % i))
    split = os.path.join(root, "split.txt")
    with open(split, "w") as fp:
        fp.write("1\n" * (n - 2) + "2\n2\n")
    return split


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Every dataset tree, and the environment that points the readers at
    them (undone at the end of the module)."""
    base = str(tmp_path_factory.mktemp("trees"))
    rng = np.random.RandomState(20)
    split = write_chairs_tree(os.path.join(base, "chairs"), rng)
    sintel_root, sintel_split = write_sintel_tree(
        os.path.join(base, "sintel"), rng)
    write_kitti_tree(os.path.join(base, "kitti"), rng)
    write_hd1k_tree(os.path.join(base, "hd1k"), rng)
    write_things3d_tree(os.path.join(base, "things3d"), rng)
    mp = pytest.MonkeyPatch()
    for name, value in (("MFN_CHAIRS_DIR", os.path.join(base, "chairs")),
                        ("MFN_CHAIRS_SPLIT", split),
                        ("MFN_SINTEL_ROOT", sintel_root),
                        ("MFN_SINTEL_SPLIT", sintel_split),
                        ("MFN_KITTI_ROOT", os.path.join(base, "kitti")),
                        ("MFN_HD1K_ROOT", os.path.join(base, "hd1k")),
                        ("MFN_THINGS3D_ROOT",
                         os.path.join(base, "things3d"))):
        mp.setenv(name, value)
    yield base
    mp.undo()


@pytest.mark.parametrize("dataset_yaml", [
    "dataset: chairs\n", "dataset: things3d\nsub_type: clean\n",
    "dataset: sintel\nkitti: 1\nhd1k: 1\n", "dataset: kitti\n",
    "dataset: kitti\ntrain_all: true\norig_shape: [20, 36]\n"],
    ids=["chairs", "things3d", "sintel_kitti_hd1k", "kitti",
         "kitti_all_native"])
def test_load_training_data_matches_jax(trees, tmp_path, dataset_yaml):
    p = tmp_path / "ds.yaml"
    p.write_text(dataset_yaml)
    argv = ["MaskFlownet_S.yaml", "--dataset_cfg", str(p)]
    got = cli.load_training_data(cli.parse_args(argv), load_config(str(p)), 4)
    want = jax_cli.load_training_data(jax_cli.parse_args(argv),
                                      jax_load_config(str(p)), 4)
    assert len(got[0]) == len(want[0]) == 4
    for g, w in zip(got[0], want[0]):
        _equal(g.arrays, w.arrays)
        assert (g.load is things3d.load) == (w.load is jax_things3d.load)
        assert (g.load is None) == (w.load is None)
    _equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[1], "no validation set"


# ---------------------------------------------------------------------------
# training/logging
# ---------------------------------------------------------------------------

def test_logs_written_by_jax_read_back_as_in_jax(tmp_path, monkeypatch):
    """A run the JAX package names and logs, found, re-read and its
    checkpoints listed by both packages; so is a run the port names."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "logs"))
    os.makedirs(os.path.join(root, "weights"))
    ids = []
    for k, mod in enumerate((jax_logging, logging)):
        when = datetime.datetime(2026, 3, 4, 5, 6, 7 + k,
                                 tzinfo=datetime.timezone.utc)
        monkeypatch.setattr(mod, "_localtime", lambda when=when: when)
        ids.append(mod.generate_run_id("8")[1])
    assert ids[0].endswith("Mar04-0506") and ids[1].endswith("Mar04-050608")
    for run_id in ids:
        log = jax_logging.FileLog(os.path.join(root, "logs",
                                               run_id + ".log"))
        log.log("start=0, train=8, batch=8, devices=8")
        log.log("config='MaskFlownet_S.yaml', dataset_cfg='chairs.yaml', "
                "batch=None, aug='host', compute_dtype='bfloat16'")
        log.log("steps=1, loss=3.5, epe=8.9, loading_time=0.020, "
                "total_time=0.000")
        log.log("steps=1, chairs=14.1, sintel.clean=9.5, kitti.15=3.0, "
                "kitti.15:kitti=0.5")
        log.log("a line, without pairs")
        log.close()
        for steps in (5000, 10000, 500):
            open(os.path.join(root, "weights", f"{run_id}_{steps}.npz"),
                 "w").close()
    for run_id in ids:
        log_file, got_id = logging.find_log(root, run_id[:3])
        assert (log_file, got_id) == jax_logging.find_log(root, run_id[:3])
        assert got_id == run_id
        assert logging.read_log(log_file) == jax_logging.read_log(log_file)
        cks = logging.find_checkpoints(root, run_id)
        assert cks == jax_logging.find_checkpoints(root, run_id)
        assert [s for _, s in cks] == [500, 5000, 10000]
    with pytest.raises(ValueError):
        logging.find_log(root, "zzz")
    # reopening keeps a backup, as in JAX
    logging.FileLog(log_file).close()
    assert os.path.exists(log_file + ".bak")


def test_run_ids_a_second_apart_differ(monkeypatch):
    """The port stamps to the second; the JAX package's ids of the same two
    moments are one id (its known collision)."""
    got = {}
    for mod in (logging, jax_logging):
        for s in (7, 8):
            when = datetime.datetime(2026, 3, 4, 5, 6, s,
                                     tzinfo=datetime.timezone.utc)
            monkeypatch.setattr(mod, "_localtime", lambda when=when: when)
            got[(mod.__name__, s)] = mod.generate_run_id("1")
    assert got[(logging.__name__, 7)] != got[(logging.__name__, 8)]
    assert got[(jax_logging.__name__, 7)] == got[(jax_logging.__name__, 8)]


def test_moving_averages_match_jax():
    values = [3.0, 1.5, 2.25, 0.0, 7.0]
    ours, theirs = logging.MovingAverage(), jax_logging.MovingAverage()
    dours, dtheirs = (logging.DictMovingAverage(),
                      jax_logging.DictMovingAverage())
    for v in values:
        ours.update(v)
        theirs.update(v)
        dours.update({"loss": v, "epe": 2 * v})
        dtheirs.update({"loss": v, "epe": 2 * v})
        assert ours.average == theirs.average
        assert dours.average == dtheirs.average


# ---------------------------------------------------------------------------
# the CLI end to end, on the CPU
# ---------------------------------------------------------------------------

def _write(path, text):
    with open(path, "w") as fp:
        fp.write(text)
    return path


@pytest.fixture(scope="module")
def cli_env(trees):
    """YAMLs for the tiny runs: MaskFlownet_S and the cascade on a 3-step
    schedule; chairs at 96x128 sources and 64x64 crops, validating at
    steps 1 and 3 with a checkpoint at 3 (or none). The checkpoint is
    deleted at the end."""
    root = os.path.join(trees, "exp")
    os.makedirs(root)
    sched = f"optimizer:\n  learning_rate:\n    - [{STEPS}, 1.0e-4]\n"
    ds = (f"dataset: chairs\nvalidation_steps: {STEPS}\n"
          f"target_shape: [{CROP[0]}, {CROP[1]}]\n"
          f"orig_shape: [{SRC[0]}, {SRC[1]}]\n")
    env = {
        "root": root,
        "s": _write(os.path.join(trees, "s.yaml"),
                    "network:\n  class: MaskFlownet_S\n" + sched),
        "cascade": _write(os.path.join(trees, "cascade.yaml"),
                          "network:\n  class: MaskFlownet\n" + sched),
        "ds": _write(os.path.join(trees, "ds.yaml"),
                     ds + f"checkpoint_steps: {STEPS}\n"),
        "ds_no_ckpt": _write(os.path.join(trees, "ds_no_ckpt.yaml"),
                             ds + "checkpoint_steps: 1000\n")}
    yield env
    shutil.rmtree(os.path.join(root, "weights"), ignore_errors=True)


def run_main(argv):
    """``cli.main(argv)`` on the CPU in f32 at the small size; returns its
    exit code and the threads it left running."""
    before = set(threading.enumerate())
    rc = cli.main(argv + ["--device", "cpu", "--compute_dtype", "float32",
                          "--batch", str(B), "--resize", RESIZE])
    return rc, [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def _log_of(root, run_id):
    with open(os.path.join(root, "logs", run_id + ".log")) as fp:
        return fp.read()


def _runs(root):
    return sorted(f[:-4] for f in os.listdir(os.path.join(root, "logs"))
                  if f.endswith(".log"))


def _check_training_log(text, steps=STEPS):
    """Finite loss and epe at every step, validation at 1 and ``steps``."""
    for s in range(1, steps + 1):
        line = next(ln for ln in text.splitlines()
                    if f"] steps={s}, loss=" in ln)
        kv = dict(x.split("=", 1) for x in line.split("] ", 1)[1].split(", "))
        assert math.isfinite(float(kv["loss"])), line
        assert math.isfinite(float(kv["epe"])), line
    for s in (1, steps):
        assert f"] steps={s}, chairs=" in text
        assert "sintel.clean=" in text and "sintel.final=" in text
    assert f"schedule exhausted at step {steps}" in text


@pytest.fixture(scope="module")
def s_run(cli_env):
    """MaskFlownet_S, host geometry (the CLI's default), 3 steps."""
    root = cli_env["root"]
    rc, alive = run_main([cli_env["s"], "--dataset_cfg", cli_env["ds"],
                          "--root", root])
    (run_id,) = _runs(root)
    return rc, alive, run_id


def test_cli_s_run_with_host_geometry(cli_env, s_run):
    rc, alive, run_id = s_run
    assert rc == 0 and not alive
    text = _log_of(cli_env["root"], run_id)
    _check_training_log(text)
    assert "aug='host'" in text and "device='cpu'" in text
    assert "devices=1" in text
    (ck,) = logging.find_checkpoints(cli_env["root"], run_id)
    assert ck[1] == STEPS
    state = interop.read_npz(ck[0], param_shapes())
    assert state["step"] == STEPS and state["mu"] is not None


def test_cli_resume_restores_args_and_state(cli_env, s_run, capsys):
    """``-c`` with the run's prefix: the log's args (the compute dtype the
    resume leaves at its default) come back, the checkpoint loads with its
    moments at step 3, and the exhausted schedule ends the run."""
    root, run_id = cli_env["root"], s_run[2]
    before = set(threading.enumerate())
    rc = cli.main([cli_env["s"], "--dataset_cfg", cli_env["ds"], "--root",
                   root, "-c", run_id[:3], "--device", "cpu", "--resize",
                   RESIZE])
    assert rc == 0
    assert not [t for t in threading.enumerate() if t not in before]
    out = capsys.readouterr().out
    assert "Restored batch=2" in out
    assert "Restored compute_dtype='float32'" in out
    text = _log_of(root, run_id)
    assert f"start={STEPS}, train=" in text
    assert text.count(f"schedule exhausted at step {STEPS}") == 2
    assert len(logging.find_checkpoints(root, run_id)) == 1


def test_cli_device_cache_run(cli_env, s_run):
    """``--device_cache 2`` (so ``--aug device``), a profile of step 3,
    no checkpoint."""
    root = os.path.join(cli_env["root"], "cache")
    rc, alive = run_main([cli_env["s"], "--dataset_cfg",
                          cli_env["ds_no_ckpt"], "--root", root,
                          "--device_cache", "2", "--profile", "3,3"])
    assert rc == 0 and not alive
    (run_id,) = _runs(root)
    text = _log_of(root, run_id)
    _check_training_log(text)
    assert "aug='device'" in text and "device_cache=2" in text
    assert os.listdir(os.path.join(root, "profile")) == [
        f"{run_id}_3-3.json"]
    assert not os.listdir(os.path.join(root, "weights"))


def test_cli_twopass_run(cli_env, s_run, monkeypatch):
    """``--device_cache 2 --aug_sampler twopass``: the device augmentation
    samples through ``affine_sample_twopass`` (images, then labels) at
    every step, none through ``affine_sample``."""
    import maskflownet_torch.augment.geometry as geometry
    calls = {"twopass": 0, "affine": 0}
    for name, attr in (("twopass", "affine_sample_twopass"),
                       ("affine", "affine_sample")):
        real = getattr(geometry, attr)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(geometry, attr, spy)
    root = os.path.join(cli_env["root"], "twopass")
    rc, alive = run_main([cli_env["s"], "--dataset_cfg",
                          cli_env["ds_no_ckpt"], "--root", root,
                          "--device_cache", "2", "--aug_sampler", "twopass"])
    assert rc == 0 and not alive
    (run_id,) = _runs(root)
    text = _log_of(root, run_id)
    _check_training_log(text)
    assert "aug='device'" in text and "aug_sampler='twopass'" in text
    assert calls == {"twopass": 2 * STEPS, "affine": 0}


@pytest.fixture(scope="module")
def cascade_run(cli_env, s_run):
    """The cascade from the S run's checkpoint with ``--clear_steps``
    (``load_head``, the frozen head), augmented through the device cache,
    no checkpoint; its ``Trainer`` is kept."""
    root = cli_env["root"]
    trainers = []

    class Kept(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "Trainer", Kept)
        rc, alive = run_main([cli_env["cascade"], "--dataset_cfg",
                              cli_env["ds_no_ckpt"], "--root", root, "-c",
                              f"{s_run[2]}:{STEPS}", "--clear_steps",
                              "--device_cache", "2"])
    (run_id,) = set(_runs(root)) - {s_run[2]}
    return rc, alive, run_id, trainers


def test_cli_cascade_from_the_s_run_keeps_its_head(cli_env, s_run,
                                                   cascade_run):
    rc, alive, run_id, (trainer,) = cascade_run
    assert rc == 0 and not alive
    root = cli_env["root"]
    text = _log_of(root, run_id)
    _check_training_log(text)
    assert "start=0," in text and "clear_steps=True" in text
    assert trainer.steps == STEPS and trainer.settings.fix_head
    ((s_ck, _),) = logging.find_checkpoints(root, s_run[2])
    state = trainer.state_dict()
    with np.load(s_ck) as s:
        head = [k for k in s.files if k.startswith("p:")]
        assert head
        for k in head:
            np.testing.assert_array_equal(
                state["p:" + HEAD_SCOPE + "/" + k[2:]], s[k])
    # Adam stepped stage 2 and not the head
    assert any(np.any(v) for k, v in state.items()
               if k.startswith("mu:") and HEAD_SCOPE not in k)
    assert not any(np.any(v) for k, v in state.items()
                   if k.startswith(f"mu:{HEAD_SCOPE}/"))


def _s_trainer(ck):
    trainer = Trainer(TrainSettings(compute_dtype="float32"), device="cpu")
    trainer.load(ck, load_states=False)
    return trainer


def test_cli_valid_on_sintel_and_kitti(cli_env, s_run):
    root, run_id = cli_env["root"], s_run[2]
    rc, alive = run_main([cli_env["s"], "--dataset_cfg", cli_env["ds"],
                          "--root", root, "-c", run_id, "--valid"])
    assert rc == 0 and not alive
    with open(os.path.join(root, "logs", "val", run_id + ".val.log")) as fp:
        lines = [ln.split("] ", 1)[1] for ln in fp.read().splitlines()]
    keys = [ln.split(", ", 1)[1].split("=")[0] for ln in lines]
    assert keys == [f"sintel.{d}.{p}:epe" for d in ("training2", "training")
                    for p in ("clean", "final")] + [
        f"kitti.{e}:{m}" for e in ("2012", "2015") for m in ("epe", "kitti")]
    values = {k: float(ln.rsplit("=", 1)[1]) for k, ln in zip(keys, lines)}
    assert all(math.isfinite(v) for v in values.values())
    assert all(ln.startswith(f"steps={STEPS}, ") for ln in lines)
    # the same numbers from the Trainer itself
    ((ck, _),) = logging.find_checkpoints(root, run_id)
    trainer = _s_trainer(ck)
    final = sintel.list_data()["training"]["final"]
    cols = [[sintel.load(p) for p in col] for col in zip(*final)]
    assert values["sintel.training.final:epe"] == trainer.validate(
        *cols, batch_size=B, resize=(64, 128))
    d = kitti.read_dataset(editions="2015", parts="mixed",
                           resize=(1224, 370))
    assert (values["kitti.2015:epe"], values["kitti.2015:kitti"]) == \
        trainer.validate(d["image_0"], d["image_1"], d["flow"], d["occ"],
                         batch_size=B, resize=(64, 128), return_type="both")


def test_cli_predict_writes_the_submission_files(cli_env, s_run):
    root, run_id = cli_env["root"], s_run[2]
    rc, alive = run_main([cli_env["s"], "--dataset_cfg", cli_env["ds"],
                          "--root", root, "-c", run_id, "--predict"])
    assert rc == 0 and not alive
    ((ck, _),) = logging.find_checkpoints(root, run_id)
    out = os.path.join(root, "flows", os.path.basename(ck)[:-4])
    trainer = _s_trainer(ck)
    test = sintel.list_data()["test"]["final"]
    flows = trainer.predict([sintel.load(a) for a, _ in test],
                            [sintel.load(b) for _, b in test],
                            batch_size=B, resize=(64, 128))
    for (img1, _), (flow, _, _) in zip(test, flows):
        got = codecs.flo_load(os.path.join(
            out, "final", os.path.basename(os.path.dirname(img1)),
            os.path.basename(img1).replace(".png", ".flo")))
        np.testing.assert_array_equal(got, flow[..., ::-1])
    testing = kitti.read_dataset_testing()
    for ed in ("2012", "2015"):
        flows = list(trainer.predict(testing[ed]["image_0"],
                                     testing[ed]["image_1"], batch_size=B,
                                     resize=(64, 128)))
        assert sorted(os.listdir(os.path.join(out, "kitti_" + ed))) == [
            "%06d_10.png" % k for k in range(len(flows))]
        for k, (flow, _, _) in enumerate(flows):
            np.testing.assert_array_equal(
                codecs.png16_load(os.path.join(out, "kitti_" + ed,
                                               "%06d_10.png" % k)),
                codecs.kitti_flow_encode(flow))


def test_cli_refuses_the_cpu_unless_asked_and_several_processes(
        cli_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cli_env["s"], "--dataset_cfg", cli_env["ds"], "--root",
            os.path.join(cli_env["root"], "refused")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    # several processes are joined through a coordinator, which must be
    # named (tests/test_torch_data_parallel.py runs two)
    monkeypatch.setenv("MFN_NUM_PROCESSES", "2")
    monkeypatch.delenv("MFN_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(argv + ["--device", "cpu"])
