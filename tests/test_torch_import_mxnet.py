"""The port's MXNet ``.params`` importer (``maskflownet_torch/tools/
import_mxnet.py``) against the JAX package's and against the numpy oracle
of the reference network (``tests/oracle_mxnet.py``).

Synthetic Gluon checkpoints at the published widths (random weights, He
scale so activations stay finite), written in the real NDArray-list
format: read by both packages, imported bitwise equal to the JAX import
after HWIO -> OIHW, and the port's forward on the import against the
oracle's on the Gluon arrays (f32 against f64, 2e-5 relative, the JAX
test's bound). The JAX imports (each a ``jax.eval_shape`` of the model)
run once per network and channel order, in a module fixture; no JAX
``Trainer`` is built. The full-width files are deleted at teardown."""

import functools
import shutil
import struct

import numpy as np
import pytest
import torch

import oracle_mxnet as oracle
from maskflownet_torch import interop, nn
from maskflownet_torch.models import ModelConfig, build_model, param_shapes
from maskflownet_torch.tools import import_mxnet as imx
from maskflownet_tpu.tools import import_mxnet as jax_imx

NETWORKS = ("MaskFlownet_S", "MaskFlownet")
CASES = [(n, o) for n in NETWORKS for o in ("rgb", "bgr")]
REL = 2e-5


def gluon_checkpoint(network, seed=7):
    """A Gluon-named, MXNet-laid-out checkpoint covering ``network``:
    ``.0.`` child indices, bare ``pred_*``/``deform*``/``dc_conv7``
    blocks, the cascade's head under ``MaskFlownet_S.``."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shp in sorted(param_shapes(model=network).items()):
        scope, name = "", key
        if name.startswith("MaskFlownet_S/"):
            scope, name = "MaskFlownet_S.", name[len("MaskFlownet_S/"):]
        block, leaf = name.split("/")
        bare = block.startswith(("pred_", "deform")) or block == "dc_conv7"
        gk = (scope + block + ("." if bare else ".0.")
              + ("weight" if leaf == "w" else "bias"))
        if leaf == "b":
            arr = rng.randn(*shp) * 0.05
        else:
            cout, cin, kh, kw = shp                 # the port's OIHW
            if block.startswith("upfeat"):          # Conv2DTranspose
                shp = (cin, cout, kh, kw)
            arr = rng.randn(*shp) / np.sqrt(kh * kw * cin)
        out[gk] = arr.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """network -> (Gluon dict, .params path); the directory goes at
    teardown."""
    d = tmp_path_factory.mktemp("mxnet")
    out = {}
    for network in NETWORKS:
        gluon = gluon_checkpoint(network)
        path = str(d / f"{network}.params")
        imx.write_mxnet_params(path, gluon)
        out[network] = (gluon, path)
    out["dir"] = d
    yield out
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_imports(files):
    """(network, order) -> the JAX import, each computed once. The JAX
    shape inference is deterministic, so it runs once a network here (the
    JAX import calls it on every import)."""
    cache = {}

    def get(network, order):
        if (network, order) not in cache:
            cache[network, order] = jax_imx.import_checkpoint(
                files[network][1], network, input_channel_order=order)
        return cache[network, order]

    shapes = functools.cache(jax_imx.expected_param_shapes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_imx, "expected_param_shapes", shapes)
        yield get


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

ARRAYS = {
    "conv1a.0.weight": np.arange(16 * 3 * 9, dtype=np.float32)
    .reshape(16, 3, 3, 3) / 7,
    "conv1a.0.bias": np.linspace(-1, 1, 16).astype(np.float32),
    "some.float16": np.linspace(-3, 3, 20).astype(np.float16).reshape(4, 5),
    "some.float64": np.linspace(-3, 3, 6).reshape(2, 3),
    "an.int64": np.arange(6, dtype=np.int64).reshape(2, 3),
    "a.uint8": np.arange(5, dtype=np.uint8),
    "scalarish": np.ones(1, np.float32),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_file_written_by_one_package_reads_in_both(tmp_path, writer):
    path = str(tmp_path / "x.params")
    (jax_imx if writer == "jax" else imx).write_mxnet_params(path, ARRAYS)
    got, want = imx.read_mxnet_params(path), jax_imx.read_mxnet_params(path)
    _assert_same(got, want)
    _assert_same(got, ARRAYS)


def _record(kind, arr):
    """One NDArray record by hand: V1, V3 or the legacy uint32-dims one."""
    flag = {np.dtype(np.float32): 0, np.dtype(np.float16): 2}[arr.dtype]
    if kind == "legacy":
        head = struct.pack(f"<I{arr.ndim}I", arr.ndim, *arr.shape)
    elif kind == "v1":
        head = struct.pack(f"<II{arr.ndim}q", 0xF993FAC8, arr.ndim, *arr.shape)
    else:
        head = struct.pack(f"<IiI{arr.ndim}q", 0xF993FACA, 0, arr.ndim,
                           *arr.shape)
    return head + struct.pack("<iii", 1, 0, flag) + arr.tobytes()


@pytest.mark.parametrize("kind", ["v1", "v3", "legacy"])
def test_record_versions_and_prefixes_read_as_the_jax_reader(tmp_path, kind):
    arrays = {"arg:conv1a.0.weight": ARRAYS["conv1a.0.weight"],
              "aux:some.float16": ARRAYS["some.float16"],
              "plain.bias": ARRAYS["conv1a.0.bias"]}
    body = [struct.pack("<QQQ", 0x112, 0, len(arrays))]
    body += [_record(kind, a) for a in arrays.values()]
    body.append(struct.pack("<Q", len(arrays)))
    body += [struct.pack("<Q", len(k)) + k.encode() for k in arrays]
    path = tmp_path / "x.params"
    path.write_bytes(b"".join(body))
    got = imx.read_mxnet_params(str(path))
    _assert_same(got, jax_imx.read_mxnet_params(str(path)))
    assert list(got) == ["conv1a.0.weight", "some.float16", "plain.bias"]


def test_reader_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.params"
    path.write_bytes(struct.pack("<QQQ", 0x113, 0, 0))
    with pytest.raises(ValueError, match="not an MXNet NDArray file"):
        imx.read_mxnet_params(str(path))
    imx.write_mxnet_params(str(path), {"w": ARRAYS["conv1a.0.weight"]})
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises((ValueError, struct.error)):
        imx.read_mxnet_params(str(path))


# ---------------------------------------------------------------------------
# names and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [
    "conv1a.0.weight", "conv1a.0.bias", "pred_flow6.weight",
    "deform5.weight", "upfeat5.0.weight", "MaskFlownet_S.conv2f.0.bias",
    "MaskFlownet_S.upfeat2.0.weight", "dc_conv7.bias"])
def test_map_key_matches_jax(key):
    assert imx.map_key(key) == jax_imx.map_key(key)


def test_map_key_refuses_unknown_keys():
    for key in ("weird.thing.extra.weight", "conv1a.0.gamma"):
        with pytest.raises(ValueError, match="unrecognized"):
            imx.map_key(key)


@pytest.mark.parametrize("kind", ["conv", "deconv", "bias"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
def test_convert_array_is_the_jax_layout_in_oihw(kind, dtype):
    rng = np.random.RandomState(3)
    arr = rng.randn(*((5,) if kind == "bias" else (5, 3, 4, 4))).astype(dtype)
    got = imx.convert_array(arr, kind)
    want = interop.params_from_jax({"w": jax_imx.convert_array(arr, kind)})
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert torch.equal(torch.from_numpy(got), want["w"])


def test_deconv_import_is_mxnet_conv2d_transpose():
    """MXNet's (Cin, Cout, kh, kw) Deconvolution weight through the import
    and ``nn.deconv``: the oracle's ``conv2d_transpose``."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 4, 6)
    w = rng.randn(5, 3, 4, 4)
    b = rng.randn(3)
    want = oracle.conv2d_transpose(x, w, b)
    params = {"d/w": torch.from_numpy(imx.convert_array(w, "deconv")),
              "d/b": torch.from_numpy(b.astype(np.float32))}
    got = nn.deconv(nn.apply_ctx(params), "d",
                    torch.from_numpy(x.astype(np.float32)), 3, act=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_permute_input_channels_reverses_the_image_channels_only():
    w1a = np.arange(2 * 3 * 9, dtype=np.float32).reshape(2, 3, 3, 3)
    w1x = np.arange(2 * 4 * 9, dtype=np.float32).reshape(2, 4, 3, 3)
    other = np.ones((2, 3, 3, 3), np.float32)
    params = {"conv1a/w": w1a, "MaskFlownet_S/conv1a/w": w1a,
              "conv1x/w": w1x, "conv1b/w": other, "conv1a/b": np.ones(2)}
    got = imx.permute_input_channels(params)
    for key in ("conv1a/w", "MaskFlownet_S/conv1a/w"):
        np.testing.assert_array_equal(got[key], w1a[:, ::-1])
    np.testing.assert_array_equal(got["conv1x/w"][:, :3], w1x[:, 2::-1])
    np.testing.assert_array_equal(got["conv1x/w"][:, 3], w1x[:, 3])
    assert got["conv1b/w"] is other and got["conv1a/b"] is params["conv1a/b"]
    np.testing.assert_array_equal(params["conv1a/w"], w1a)   # not in place


@pytest.mark.parametrize("network", NETWORKS)
def test_expected_shapes_are_the_jax_shapes_in_oihw(network, jax_imports):
    got = imx.expected_param_shapes(network)
    jax_shapes = {k: v.shape for k, v in jax_imports(network, "rgb").items()}
    assert set(got) == set(jax_shapes)
    for k, s in jax_shapes.items():
        assert got[k] == ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s), k


# ---------------------------------------------------------------------------
# whole checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network,order", CASES)
def test_import_checkpoint_equals_the_jax_import(files, jax_imports, network,
                                                 order):
    got = imx.import_checkpoint(files[network][1], network,
                                input_channel_order=order)
    want = interop.params_from_jax(jax_imports(network, order))
    assert set(got) == set(want) == set(param_shapes(model=network))
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_strict_mode_names_missing_unknown_and_oihw_shapes(files, jax_imports):
    gluon = dict(files["MaskFlownet_S"][0])
    del gluon["conv1b.0.weight"]
    gluon["mystery.weight"] = np.zeros((1, 1, 3, 3), np.float32)
    gluon["upfeat5.0.weight"] = np.zeros((128, 16, 3, 3), np.float32)
    path = str(files["dir"] / "bad.params")
    imx.write_mxnet_params(path, gluon)
    with pytest.raises(ValueError) as err:
        imx.import_checkpoint(path, "MaskFlownet_S")
    msg = str(err.value)
    assert "missing 1: ['conv1b/w']" in msg
    assert "unknown 1: ['mystery/w']" in msg
    want = param_shapes()["upfeat5/w"]
    assert (f"shape mismatches (OIHW): upfeat5/w (16, 128, 3, 3)!={want}"
            in msg and want[2:] == (4, 4))
    jax_imports("MaskFlownet_S", "rgb")         # the memoised shapes
    with pytest.raises(ValueError, match="missing"):
        jax_imx.import_checkpoint(path, "MaskFlownet_S")
    with pytest.raises(ValueError, match="input_channel_order"):
        imx.import_checkpoint(files["MaskFlownet_S"][1], "MaskFlownet_S",
                              input_channel_order="yuv")
    lenient = imx.import_checkpoint(path, "MaskFlownet_S", strict=False)
    assert "mystery/w" in lenient and "conv1b/w" not in lenient


def test_main_writes_the_jax_tools_npz(files, jax_imports):
    """Both packages' ``main`` on one file: the same ``.npz`` key for key,
    read back by ``interop`` bitwise as the in-memory import."""
    src, d = files["MaskFlownet_S"][1], files["dir"]
    jax_imports("MaskFlownet_S", "bgr")         # the memoised shapes
    outs = {}
    for name, module in (("port", imx), ("jax", jax_imx)):
        outs[name] = str(d / f"{name}.npz")
        assert module.main([src, outs[name], "--network", "MaskFlownet_S",
                            "--step", "123", "--input_channel_order",
                            "bgr"]) == 0
    with np.load(outs["port"]) as p, np.load(outs["jax"]) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k])
    back = interop.read_npz(outs["port"])
    assert back["step"] == 123 and back["mu"] is None
    want = imx.import_checkpoint(src, "MaskFlownet_S",
                                 input_channel_order="bgr")
    for k, v in want.items():
        assert torch.equal(back["params"][k], v), k


# ---------------------------------------------------------------------------
# the forward on an import against the reference's, in numpy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return tuple(rng.rand(1, 3, 64, 128).astype(np.float32) - 0.5
                 for _ in range(2))


@pytest.mark.parametrize("network,order", CASES)
def test_forward_on_the_import_matches_the_oracle(files, images, network,
                                                  order):
    """f32 port forward on the imported parameters against the oracle's
    f64 reference forward on the Gluon arrays, 2e-5 of the flows' scale.
    ``bgr``: the import of a BGR-trained checkpoint run on RGB images is
    the original checkpoint run on BGR images."""
    gluon, path = files[network]
    im1, im2 = images
    params = imx.import_checkpoint(path, network, input_channel_order=order)
    with torch.no_grad():
        preds, visuals, _ = build_model(network)(
            nn.apply_ctx(params, torch.float32), torch.from_numpy(im1),
            torch.from_numpy(im2), ModelConfig())
    o1, o2 = (im1, im2) if order == "rgb" else (im1[:, ::-1], im2[:, ::-1])
    forward = (oracle.maskflownet_s_forward if network == "MaskFlownet_S"
               else oracle.maskflownet_forward)
    o_preds, o_visuals, _ = forward(gluon, o1, o2)
    assert len(preds) == len(o_preds) == 5
    for i, (want, got) in enumerate(zip(o_preds, preds)):
        scale = max(1.0, np.max(np.abs(want)))
        err = np.max(np.abs(want - got.numpy()))
        assert err / scale < REL, (i, err, scale)
    # the occlusion mask of S; the cascade's flow2 channel 0
    want, got = o_visuals[0], visuals[0].numpy()
    assert np.max(np.abs(want - got)) / max(1.0, np.max(np.abs(want))) < REL
