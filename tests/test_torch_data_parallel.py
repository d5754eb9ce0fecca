"""Data-parallel training of the port over processes, on the CPU: two gloo
ranks (spawned once for the module, ``_rank`` below) against one process
on the whole batch.

* ``make_mesh``, ``shard_batch``, ``batch_sharding``;
* the augmented f32 MaskFlownet_S step (64x128 crops from 96x128
  sources, the chairs presets) as 2 ranks x batch 1 against 1 process x
  batch 2 with the same seed, so the same draws: the global loss and epe
  within 1e-6 relative, every all-reduced gradient within 1e-5 of its
  norm, each parameter after 2 steps within 1e-2 of the norm of its
  update (Adam divides each element by its gradient's scale, so an
  element whose gradient is near zero takes the rounding of the sum
  whole), and the two replicas bitwise equal;
* a data-parallel step of the cascade with ``fix_head``: the head bitwise
  unchanged, the rest moved, the replicas equal;
* the batch is global: the CLI refuses a batch the process count does not
  divide, and a rank loads and steps on its slots of the global batch
  only, writing no log and no checkpoint;
* the CLI's sharded loader (seed, shard and slots of rank r) against the
  JAX ``TrainLoader`` with ``shard_index``/``num_shards``, bitwise;
* ``python -m maskflownet_torch.cli.main`` as 2 processes
  (``MFN_NUM_PROCESSES=2 --device cpu``) on a tiny chairs tree: both exit
  0, rank 0 alone writes the log and the checkpoint, which reads back.

No JAX model is built or compiled: the one-process step is the port's,
which ``tests/test_torch_training.py`` and ``tests/test_torch_augment.py``
hold against the JAX step. The module's top level imports no JAX, so the
ranks it spawns do not either.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import maskflownet_torch.cli.main as cli
from maskflownet_torch import interop
from maskflownet_torch.config import presets
from maskflownet_torch.models import HEAD_SCOPE, init_params, param_shapes
from maskflownet_torch.parallel import (Mesh, all_reduce_mean, batch_sharding,
                                        initialize_distributed, make_mesh,
                                        replicated_sharding, shard_batch,
                                        shutdown_distributed)
from maskflownet_torch.training import TrainSettings, Trainer

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WORLD, STEPS, LR = 2, 2, 1e-4
SRC, HW = (96, 128), (64, 128)
CASCADE_HW = (64, 64)
# the tolerances of the S step, 2 ranks against one process: the same
# per-sample arithmetic, the batch mean taken in another order
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL = 1e-6, 1e-5, 1e-2
# each process's time limit
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def s_settings():
    return TrainSettings(compute_dtype="float32",
                         color=presets.color_aug_config("chairs"),
                         geo=presets.geometry_aug_config("chairs", HW, SRC))


def cascade_settings():
    return TrainSettings(model="MaskFlownet", fix_head=True,
                         compute_dtype="float32")


def global_batch(hw, seed):
    """A global batch of WORLD samples: uint8 NCHW images in [0, 255], f32
    (dy, dx) flow."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(x) for x in (
        rng.randint(0, 256, (WORLD, 3) + hw).astype(np.uint8),
        rng.randint(0, 256, (WORLD, 3) + hw).astype(np.uint8),
        (rng.randn(WORLD, 2, *hw) * 3).astype(np.float32))]


def digest(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().numpy().tobytes())
    return h.hexdigest()


def run_s(mesh, rows):
    """STEPS augmented S steps on ``rows`` of the global batch: the global
    metrics of each, the gradients the first step hands to Adam (after
    the all-reduce) and the parameters after the last."""
    trainer = Trainer(s_settings(), device="cpu", params=init_params(0),
                      mesh=mesh)
    grads = {}
    apply = trainer.apply_gradients

    def record(lr):
        if not grads:
            grads.update({k: p.grad.clone() for k, p in
                          trainer.params.items() if p.grad is not None})
        apply(lr)

    trainer.apply_gradients = record
    batch = [x[rows] for x in global_batch(SRC, 0)]
    metrics = [trainer.train_batch(*batch, lr=LR, sync=True)
               for _ in range(STEPS)]
    return metrics, grads, {k: v.detach() for k, v in trainer.params.items()}


def _rank(rank: int, port: int, out: str) -> None:
    """One of the module's two gloo ranks: every data-parallel check's
    reading, written to ``out``/rank<r>.json (and the S step's gradients
    and parameters to rank<r>.pt)."""
    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", WORLD, rank, device="cpu")
    got = {}
    try:
        mesh = make_mesh("cpu")
        got["mesh"] = [mesh.rank, mesh.world, str(mesh.device),
                       mesh.group is not None]
        arrays = (np.arange(12, dtype=np.uint8).reshape(2, 3, 2) + rank,
                  np.full((2, 1), rank, np.float16))
        placed = shard_batch(mesh, arrays)
        got["shard_batch"] = all(
            t.device.type == "cpu" and t.is_contiguous()
            and np.array_equal(t.numpy(), a) and t.numpy().dtype == a.dtype
            for t, a in zip(placed, arrays))
        got["batch_sharding"] = [[s.start, s.stop] for s in
                                 (batch_sharding(mesh, 2),
                                  batch_sharding(mesh, 8))]
        mine = [torch.full((3,), float(rank + 1))]
        replicated_sharding(mesh, mine)
        got["replicated"] = mine[0].tolist()
        mean = [torch.full((2,), float(rank)), torch.tensor([4.0 * rank])]
        all_reduce_mean(mesh, mean)
        got["all_reduce_mean"] = [t.tolist() for t in mean]

        metrics, grads, params = run_s(mesh, slice(rank, rank + 1))
        got["s_metrics"], got["s_digest"] = metrics, digest(params)
        torch.save({"grads": grads, "params": params},
                   os.path.join(out, f"rank{rank}.pt"))

        start = init_params(1, model="MaskFlownet")
        trainer = Trainer(cascade_settings(), device="cpu", params=start,
                          mesh=mesh)
        img1, img2, flow = (x[rank:rank + 1]
                            for x in global_batch(CASCADE_HW, 1))
        m = trainer.train_batch(img1, img2, flow, lr=LR, sync=True)
        head = [k for k in start if k.startswith(HEAD_SCOPE + "/")]
        got["cascade"] = {
            "finite": all(map(np.isfinite, m.values())),
            "head_unchanged": all(torch.equal(trainer.params[k].detach(),
                                              start[k]) for k in head),
            "rest_moved": sum(not torch.equal(trainer.params[k].detach(),
                                              start[k])
                              for k in start if k not in head),
            "rest": len(start) - len(head),
            "digest": digest(trainer.params)}

        try:
            cli.main(["MaskFlownet_S.yaml", "--device", "cpu", "--batch",
                      "3", "--root", os.path.join(out, f"cli{rank}")])
            got["odd_batch"] = "accepted"
        except SystemExit as e:
            got["odd_batch"] = str(e)
    finally:
        shutdown_distributed()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fp:
            json.dump(got, fp)


def spawn_ranks(target: str, out: str, env=None, args=()):
    """Start WORLD processes running ``test_torch_data_parallel.<target>``
    (``args`` after the rank and a free port) or, for a ``-m`` target, that
    module with ``MFN_PROCESS_ID`` set. Returns the processes."""
    port = free_port()
    procs = []
    for rank in range(WORLD):
        if target.startswith("-m"):
            cmd = [sys.executable, *target.split(), *args]
            penv = {**os.environ, **(env or {}),
                    "MFN_COORDINATOR": f"localhost:{port}",
                    "MFN_NUM_PROCESSES": str(WORLD),
                    "MFN_PROCESS_ID": str(rank)}
        else:
            code = (f"import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; "
                    f"import test_torch_data_parallel as t; "
                    f"t.{target}({rank}, {port}, {out!r})")
            cmd, penv = [sys.executable, "-c", code], dict(os.environ)
        penv.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=penv,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def wait_all(procs):
    """Each process's (exit code, output), every one waited for."""
    results = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        results.append((p.returncode, text))
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' readings, and the one-process S run on the whole
    batch (computed while the ranks run)."""
    out = str(tmp_path_factory.mktemp("dp"))
    procs = spawn_ranks("_rank", out)
    one = run_s(None, slice(0, WORLD))
    done = wait_all(procs)
    for rc, text in done:
        assert rc == 0, text[-3000:]
    got = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as fp:
            got.append(json.load(fp))
    yield got, torch.load(os.path.join(out, "rank0.pt")), one
    for r in range(WORLD):
        os.remove(os.path.join(out, f"rank{r}.pt"))


def test_make_mesh_and_shard_batch(ranks):
    got, _, _ = ranks
    for r, g in enumerate(got):
        assert g["mesh"] == [r, WORLD, "cpu", True]
        assert g["shard_batch"]
        assert g["batch_sharding"] == [[r, r + 1], [4 * r, 4 * r + 4]]
        assert g["replicated"] == [1.0, 1.0, 1.0]      # rank 0's
        assert g["all_reduce_mean"] == [[0.5, 0.5], [2.0]]
    # one process, no group: nothing to reduce, broadcast or split
    mesh = make_mesh("cpu")
    assert mesh == Mesh(0, 1, torch.device("cpu"), None)
    t = [torch.ones(2)]
    all_reduce_mean(mesh, t)
    replicated_sharding(mesh, t)
    assert t[0].tolist() == [1.0, 1.0]
    assert batch_sharding(mesh, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(Mesh(0, 2, torch.device("cpu"), None), 3)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(None, 2, 0, device="cpu")


def test_data_parallel_s_step_matches_one_process(ranks):
    got, rank0, (metrics, grads, params) = ranks
    for g in got:
        for dp, one in zip(g["s_metrics"], metrics):
            for k in ("loss", "epe"):
                assert abs(dp[k] - one[k]) <= LOSS_RTOL * abs(one[k]), (k, dp,
                                                                      one)
    assert rank0["grads"].keys() == grads.keys()
    worst = max(((rank0["grads"][k] - grads[k]).norm()
                 / grads[k].norm()).item() for k in grads
                if grads[k].norm() > 0)
    assert worst <= GRAD_RTOL
    start = init_params(0)
    worst = max(((rank0["params"][k] - params[k]).norm()
                 / (params[k] - start[k]).norm()).item() for k in params)
    assert worst <= UPDATE_RTOL


def test_replicas_stay_identical(ranks):
    got, rank0, _ = ranks
    assert got[0]["s_digest"] == got[1]["s_digest"] == digest(
        rank0["params"])
    assert got[0]["cascade"]["digest"] == got[1]["cascade"]["digest"]


def test_cascade_frozen_head_data_parallel_step(ranks):
    for g in ranks[0]:
        c = g["cascade"]
        assert c["finite"] and c["head_unchanged"]
        assert c["rest_moved"] == c["rest"] > 0


def test_the_batch_is_global(ranks, monkeypatch, tmp_path):
    """``--batch`` is the global batch: 3 does not split over 2 processes,
    and rank 1 of 2 loads and steps on its one slot of a global batch of
    2, with its own loader seed and shard, and writes nothing. (The JAX
    CLI's processes would load 2 samples each.)"""
    for g in ranks[0]:
        assert "global batch 3 must be divisible by the process count 2" \
            in g["odd_batch"]
    from test_torch_cli import write_chairs_tree
    rng = np.random.RandomState(3)
    split = write_chairs_tree(str(tmp_path / "chairs"), rng)
    monkeypatch.setenv("MFN_CHAIRS_DIR", str(tmp_path / "chairs"))
    monkeypatch.setenv("MFN_CHAIRS_SPLIT", split)
    monkeypatch.setenv("MFN_SINTEL_ROOT", str(tmp_path / "none"))
    (tmp_path / "ds.yaml").write_text(
        f"dataset: chairs\nvalidation_steps: 2\ncheckpoint_steps: 2\n"
        f"target_shape: [64, 64]\norig_shape: [{SRC[0]}, {SRC[1]}]\n")
    (tmp_path / "s.yaml").write_text(
        "network:\n  class: MaskFlownet_S\noptimizer:\n  learning_rate:\n"
        "    - [2, 1.0e-4]\n")
    loaders, batches = [], []
    real_loader = cli.TrainLoader

    def loader(datasets, batch_size, orig_shape, **kw):
        loaders.append((len(datasets), batch_size, kw))
        return real_loader(datasets, batch_size, orig_shape, **kw)

    real_step = Trainer.train_batch_device

    def step(self, batch, lr=1e-4):
        batches.append((batch[0].shape[0], self.world))
        return real_step(self, batch, lr)

    monkeypatch.setattr(cli, "TrainLoader", loader)
    monkeypatch.setattr(Trainer, "train_batch_device", step)
    root = tmp_path / "exp"
    args = cli.parse_args([str(tmp_path / "s.yaml"), "--dataset_cfg",
                           str(tmp_path / "ds.yaml"), "--device", "cpu",
                           "--compute_dtype", "float32", "--batch", "2",
                           "--root", str(root)])
    assert cli._main(args, Mesh(1, 2, torch.device("cpu"), None)) == 0
    assert loaders == [(1, 1, dict(seed=1, shard_index=1, num_shards=2))]
    assert batches == [(1, 2), (1, 2)]
    assert sorted(os.listdir(root / "logs")) == ["debug", "val"]
    assert not os.listdir(root / "weights")


def test_sharded_loader_matches_jax():
    """Rank r of 2 as the CLI builds its loader -- its slots of the global
    ``[Dataset] * 4``, seed r, shard r of 2 -- against the JAX
    ``TrainLoader`` with the same seed and shard, bitwise."""
    from maskflownet_tpu.data import loader as jax_loader
    from maskflownet_torch.data import loader
    from test_torch_data import _columns, _equal
    cols = _columns(np.random.RandomState(5), 7, (20, 28), mask=True)
    for rank in range(WORLD):
        mesh = Mesh(rank, WORLD, torch.device("cpu"), None)
        local = batch_sharding(mesh, 4)
        got = loader.TrainLoader(([loader.Dataset(cols)] * 4)[local],
                                     2, (16, 24), seed=rank,
                                     shard_index=rank, num_shards=WORLD)
        want = jax_loader.TrainLoader([jax_loader.Dataset(cols)] * 2, 2,
                                      (16, 24), seed=rank, shard_index=rank,
                                      num_shards=WORLD)
        try:
            for _ in range(4):
                g, w = got.get(), want.get()
                _equal(g, w)
                assert g[0].shape[0] == 2
        finally:
            got.stop()


def test_cli_two_processes_end_to_end(tmp_path):
    """``python -m maskflownet_torch.cli.main`` as two gloo processes on
    the CPU, 2 steps of a global batch of 2 on a tiny chairs tree: both
    exit 0; rank 0 alone writes the log (``devices=2``) and the
    checkpoint, which reads back."""
    from test_torch_cli import write_chairs_tree
    rng = np.random.RandomState(4)
    split = write_chairs_tree(str(tmp_path / "chairs"), rng)
    (tmp_path / "ds.yaml").write_text(
        f"dataset: chairs\nvalidation_steps: 2\ncheckpoint_steps: 2\n"
        f"target_shape: [64, 64]\norig_shape: [{SRC[0]}, {SRC[1]}]\n")
    (tmp_path / "s.yaml").write_text(
        "network:\n  class: MaskFlownet_S\noptimizer:\n  learning_rate:\n"
        "    - [2, 1.0e-4]\n")
    root = tmp_path / "exp"
    env = {"MFN_CHAIRS_DIR": str(tmp_path / "chairs"),
           "MFN_CHAIRS_SPLIT": split,
           "MFN_SINTEL_ROOT": str(tmp_path / "none")}
    procs = spawn_ranks("-m maskflownet_torch.cli.main", str(tmp_path), env,
                        args=[str(tmp_path / "s.yaml"), "--dataset_cfg",
                              str(tmp_path / "ds.yaml"), "--device", "cpu",
                              "--compute_dtype", "float32", "--batch", "2",
                              "--root", str(root)])
    for rc, text in wait_all(procs):
        assert rc == 0, text[-3000:]
    logs = [f for f in os.listdir(root / "logs") if f.endswith(".log")]
    assert len(logs) == 1
    text = (root / "logs" / logs[0]).read_text()
    assert "batch=2, devices=2" in text
    assert "steps=2, loss=" in text and "schedule exhausted at step 2" in text
    (ck,) = os.listdir(root / "weights")
    assert ck == logs[0][:-4] + "_2.npz"
    state = interop.read_npz(str(root / "weights" / ck), param_shapes())
    assert state["step"] == 2
    assert all(bool(torch.isfinite(v).all())
               for v in state["params"].values())
    os.remove(root / "weights" / ck)
