"""File logger, run-id registry and EWMA metrics: the port's copy of
``maskflownet_tpu/training/logging.py``.

Parity with the reference's experiment infra: ``logger.FileLog``
(timestamped append-only file + ``.bak`` on reopen, optional screen echo,
``logger.py:5-29``), run-id generation (3-hex sha224 tag + timestamp,
``main.py:112-116``), log/checkpoint discovery by regex (``path.py:17-31``),
log re-parsing for resume (``path.py:33-53``) and the 0.95-ratio moving
averages (``main.py:427-457``).

One deliberate difference: a run id is stamped to the second
(``%b%d-%H%M%S``), where the JAX package stamps to the minute, so that two
stages started in one root within a minute get logs and checkpoints of
their own. :func:`find_log` and :func:`find_checkpoints` match either
stamp, so a run of the JAX package resumes here.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import re
import shutil
import socket
import sys

# a run id's timestamp; the JAX package's is "%b%d-%H%M"
RUN_STAMP = "%b%d-%H%M%S"


def _localtime() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


class FileLog:
    def __init__(self, path: str, screen: bool = False):
        self.path = path
        self.screen = screen
        if os.path.exists(path):
            shutil.copyfile(path, path + ".bak")
        self._fp = open(path, "a")

    def log(self, msg: str) -> None:
        stamp = _localtime().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        self._fp.write(line + "\n")
        self._fp.flush()
        if self.screen:
            print(line)
            sys.stdout.flush()

    def close(self) -> None:
        self._fp.close()


class NullLog:
    """A :class:`FileLog` that writes nothing: the log of every process
    but the first in a multi-process run."""

    def log(self, msg: str) -> None:
        del msg

    def close(self) -> None:
        pass


def generate_run_id(device_tag: str = "") -> tuple[str, str]:
    """-> (tag, run_id): 3-hex digest of host+time+devices, plus a
    timestamp to the second."""
    stamp = _localtime().strftime(RUN_STAMP)
    uid = socket.gethostname() + stamp + device_tag
    tag = hashlib.sha224(uid.encode()).hexdigest()[:3]
    return tag, tag + stamp


def list_dir(folder: str, pattern: str, groups: bool = False):
    rx = re.compile(pattern)
    if not os.path.isdir(folder):
        return
    for f in sorted(os.listdir(folder)):
        m = rx.match(f)
        if m is not None:
            yield ((os.path.join(folder, f),) + m.groups()) if groups \
                else os.path.join(folder, f)


def find_log(repo_root: str, prefix: str) -> tuple[str, str]:
    pattern = r"^(%s(.*\d)?)\.log$" % re.escape(prefix)
    rets = list(list_dir(os.path.join(repo_root, "logs"), pattern, groups=True))
    if rets:
        return rets[0][0], rets[0][1]
    raise ValueError(f"Not found {prefix}")


def find_checkpoints(repo_root: str, run_id: str) -> list[tuple[str, int]]:
    pattern = r"^{}.*_(\d+)\.npz$".format(re.escape(run_id))
    cks = list(list_dir(os.path.join(repo_root, "weights"), pattern,
                        groups=True))
    return sorted(((p, int(s)) for p, s in cks), key=lambda t: t[1])


def read_log(fname: str):
    """Re-parse a log to recover validation history and experiment args
    (reference ``path.py:33-53``)."""
    val, exp_info = [], []
    with open(fname) as fi:
        for ln in fi:
            p = ln.find("] ")
            items = ln[p + 2:].strip().split(", ")
            try:
                kvs = dict(item.split("=", 1) for item in items if "=" in item)
            except ValueError:
                continue
            if any(k.startswith(("sintel.", "kitti.", "chairs")) for k in kvs):
                val.append(kvs)
            elif "config" in kvs:
                exp_info.append(kvs)
    return val, exp_info


class MovingAverage:
    def __init__(self, ratio: float = 0.95):
        self.sum = 0.0
        self.weight = 1e-8
        self.ratio = ratio

    def update(self, v: float) -> None:
        self.sum = self.sum * self.ratio + v
        self.weight = self.weight * self.ratio + 1

    @property
    def average(self) -> float:
        return self.sum / self.weight


class DictMovingAverage:
    def __init__(self, ratio: float = 0.95):
        self.sum: dict = {}
        self.weight: dict = {}
        self.ratio = ratio

    def update(self, v: dict) -> None:
        for key, x in v.items():
            if key not in self.sum:
                self.sum[key] = 0.0
                self.weight[key] = 1e-8
            self.sum[key] = self.sum[key] * self.ratio + x
            self.weight[key] = self.weight[key] * self.ratio + 1

    @property
    def average(self) -> dict:
        return {k: self.sum[k] / self.weight[k] for k in self.sum}
