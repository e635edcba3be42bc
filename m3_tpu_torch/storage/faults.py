"""Deterministic disk-fault injection + crash points for the storage layer.

A copy of ``m3_tpu/storage/faults.py``: the port's commit log, filesets
and snapshots write through the same seam, read the same environment
variables and trip the same crash points.

The write-side twin of ``net/faults.py``: a seeded plan of rules keyed on
(operation, path class) that injects the disk failures a durability story
must survive, through ONE seam (:class:`DiskIO`) threaded under
``fs.py`` / ``commitlog.py`` / ``snapshot.py`` / ``utils/blob.py``:

- ``eio``: the write/fsync/open raises ``EIO`` before any byte lands —
  the dead-disk path;
- ``enospc``: raises ``ENOSPC`` — the full-disk path callers must degrade
  through (commitlog turns it into a typed retryable
  :class:`DiskFullError`);
- ``torn``: the payload is truncated at a seeded byte offset and the
  write then fails — what a power cut mid-write leaves on disk;
- ``bitflip``: one seeded bit of the payload is flipped and the write
  SUCCEEDS — silent media corruption, detectable only by digest
  verification (the scrubber's prey).

Every draw comes from one plan-owned RNG, so a fixed seed plus a fixed
I/O sequence replays the exact same faults. Spawned dbnodes pick a plan
up from the ``M3_TPU_DISK_FAULT_PLAN`` env var (JSON); nothing is
installed when it is unset.

Separately, **crash points** are named sites inside multi-file commit
protocols (``fileset:pre-checkpoint``, ``commitlog:mid-rotation``, ...)
that hard-exit the process when armed via ``M3_TPU_CRASH_POINT``, so a
recovery gate can SIGKILL-equivalent a node at an exact torn-state
boundary instead of a random sleep.
"""

from __future__ import annotations

import errno
import json
import os
import random
import sys
import threading
from dataclasses import asdict, dataclass

from ..utils.instrument import DEFAULT as METRICS

DISK_FAULT_PLAN_ENV = "M3_TPU_DISK_FAULT_PLAN"
CRASH_POINT_ENV = "M3_TPU_CRASH_POINT"

#: exit code a tripped crash point dies with (mirrors SIGKILL's 128+9 so
#: process-level tooling treats both the same way)
CRASH_EXIT_CODE = 137

#: every named crash site wired into the storage layer, in commit order.
#: Naming convention: ``<subsystem>:<boundary>`` where the boundary names
#: the state the disk is left in (see CONTRIBUTING.md).
CRASH_POINTS = (
    "fileset:data-written",     # data file durable, digest+checkpoint absent
    "fileset:pre-checkpoint",   # all files + digest durable, checkpoint absent
    "commitlog:mid-rotation",   # old segment closed, next segment not yet open
    "snapshot:pre-cleanup",     # new snapshot durable, superseded ones remain
)

DISK_OPS = ("open", "read", "write", "fsync", "rename")

#: path classes a rule can scope to: the fileset file roles plus the two
#: non-fileset storage dirs; anything else classifies as "other"
PATH_CLASSES = (
    "info", "index", "summaries", "bloomfilter", "data", "side",
    "digest", "checkpoint", "commitlog", "snapshot", "other",
)


class DiskFaultError(OSError):
    """Injected disk failure (EIO / torn-write surface)."""


class DiskFullError(OSError):
    """Typed retryable disk-full rejection.

    Raised by the commitlog / flush path when the disk is out of space:
    rides ``wire.RETRYABLE_ETYPES`` so clients back off and retry instead
    of erroring, and the SLO plane sees shed capacity rather than
    failures. Writes resume on their own once space frees."""

    def __init__(self, msg: str) -> None:
        super().__init__(errno.ENOSPC, msg)


def classify_path(path: str) -> str:
    """Map a storage path to its fault-plan path class.

    Temp-file spellings (``.{name}.tmp`` from the durable-write seam)
    classify the same as their final name, so a rule on ``checkpoint``
    also faults the checkpoint's temp write."""
    name = os.path.basename(path)
    if name.startswith(".") and name.endswith(".tmp"):
        name = name[1:-4]
    parts = path.replace("\\", "/").split("/")
    if name.endswith(".wal") or "commitlogs" in parts:
        return "commitlog"
    if name.startswith("snapshot") or "snapshots" in parts:
        return "snapshot"
    if name.startswith("fileset-") and name.endswith(".db"):
        bits = name[: -len(".db")].split("-")
        if len(bits) == 4 and bits[3] in PATH_CLASSES:
            return bits[3]
    return "other"


@dataclass
class DiskFaultRule:
    """One match+action row. ``op``/``path_class`` of None match anything;
    probabilities are independent draws in [0, 1]. ``max_hits`` bounds how
    many faults the rule injects in total (0 = unlimited) — a plan can say
    "exactly one torn write, then a healthy disk"."""

    op: str | None = None
    path_class: str | None = None
    eio: float = 0.0
    enospc: float = 0.0
    torn: float = 0.0
    bitflip: float = 0.0
    max_hits: int = 0
    hits: int = 0

    def matches(self, op: str, path_class: str) -> bool:
        if self.op is not None and self.op != op:
            return False
        if self.path_class is not None and self.path_class != path_class:
            return False
        return not (self.max_hits and self.hits >= self.max_hits)


class DiskFaultPlan:
    """Seeded fault schedule over (op, path class) decision points."""

    def __init__(self, rules: list[DiskFaultRule], seed: int = 0) -> None:
        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._injected = {
            kind: METRICS.counter(
                "disk_faults_injected_total",
                "disk faults injected by the active DiskFaultPlan",
                labels={"kind": kind},
            )
            for kind in ("eio", "enospc", "torn", "bitflip")
        }

    def decide(self, op: str, path_class: str, size: int = 0) -> tuple[str, int]:
        """One decision draw: (action, seeded offset).

        action ∈ {'pass','eio','enospc','torn','bitflip'}; the offset is a
        byte offset for 'torn' (truncate the payload there) and a BIT
        offset for 'bitflip' (flip that bit), drawn from the plan RNG so
        the corruption itself replays."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(op, path_class):
                    continue
                if rule.eio > 0.0 and self._rng.random() < rule.eio:
                    rule.hits += 1
                    self._injected["eio"].inc()
                    return "eio", 0
                if rule.enospc > 0.0 and self._rng.random() < rule.enospc:
                    rule.hits += 1
                    self._injected["enospc"].inc()
                    return "enospc", 0
                if rule.torn > 0.0 and self._rng.random() < rule.torn:
                    rule.hits += 1
                    self._injected["torn"].inc()
                    return "torn", self._rng.randrange(max(size, 1))
                if rule.bitflip > 0.0 and self._rng.random() < rule.bitflip:
                    rule.hits += 1
                    self._injected["bitflip"].inc()
                    return "bitflip", self._rng.randrange(max(size * 8, 1))
        return "pass", 0

    def to_json(self) -> str:
        rules = []
        for r in self.rules:
            d = asdict(r)
            d.pop("hits", None)  # runtime state, not plan spec
            rules.append(d)
        return json.dumps({"seed": self.seed, "rules": rules})

    @classmethod
    def from_json(cls, raw: str) -> "DiskFaultPlan":
        spec = json.loads(raw)
        rules = [DiskFaultRule(**r) for r in spec.get("rules", [])]
        return cls(rules, seed=int(spec.get("seed", 0)))


def plan_from_env(env=None) -> DiskFaultPlan | None:
    """A DiskFaultPlan from M3_TPU_DISK_FAULT_PLAN, or None when unset.
    Malformed JSON raises — a chaos run silently running without its
    faults would pass vacuously."""
    raw = (env if env is not None else os.environ).get(DISK_FAULT_PLAN_ENV, "")
    if not raw:
        return None
    return DiskFaultPlan.from_json(raw)


class DiskIO:
    """THE injectable I/O seam every durable write of the storage layer
    goes through. With no plan
    installed every method is a thin passthrough."""

    def __init__(self, plan: DiskFaultPlan | None = None) -> None:
        self.plan = plan

    # -- primitive ops --

    def open(self, path: str, mode: str = "rb"):
        if self.plan is not None:
            action, _ = self.plan.decide("open", classify_path(path))
            if action in ("eio", "enospc"):
                raise _os_error(action, "open", path)
        return open(path, mode)

    def read(self, f, path: str, n: int = -1) -> bytes:
        if self.plan is not None:
            action, _ = self.plan.decide("read", classify_path(path))
            if action == "eio":
                raise _os_error("eio", "read", path)
        return f.read(n)

    def write(self, f, path: str, payload: bytes) -> None:
        """One payload write. 'torn' lands a truncated prefix THEN fails
        (what the disk holds after a cut); 'bitflip' corrupts one bit and
        succeeds silently."""
        if self.plan is not None:
            action, off = self.plan.decide(
                "write", classify_path(path), len(payload)
            )
            if action in ("eio", "enospc"):
                raise _os_error(action, "write", path)
            if action == "torn":
                f.write(payload[:off])
                f.flush()
                raise _os_error("eio", "torn write", path)
            if action == "bitflip" and payload:
                buf = bytearray(payload)
                buf[off // 8] ^= 1 << (off % 8)
                f.write(bytes(buf))
                return
        f.write(payload)

    def fsync(self, f, path: str) -> None:
        if self.plan is not None:
            action, _ = self.plan.decide("fsync", classify_path(path))
            if action in ("eio", "enospc"):
                raise _os_error(action, "fsync", path)
        f.flush()
        os.fsync(f.fileno())

    def fsync_path(self, path: str) -> None:
        """fsync an already-closed file by path (migration commit)."""
        if self.plan is not None:
            action, _ = self.plan.decide("fsync", classify_path(path))
            if action in ("eio", "enospc"):
                raise _os_error(action, "fsync", path)
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def replace(self, src: str, dst: str) -> None:
        if self.plan is not None:
            action, _ = self.plan.decide("rename", classify_path(dst))
            if action in ("eio", "enospc"):
                raise _os_error(action, "rename", dst)
        os.replace(src, dst)

    # -- the shared durable-write primitive --

    def write_durable(self, path: str, payload: bytes) -> None:
        """write-temp → fsync → rename: the ONE way storage code lands a
        whole durable file. A crash or fault at any point leaves either
        the old file or no file — never a torn final path. The temp file
        classifies as its final name, so faults aimed at e.g.
        ``checkpoint`` hit here too; a failed temp write is removed."""
        d = os.path.dirname(path) or "."
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
        try:
            with self.open(tmp, "wb") as f:
                self.write(f, path, payload)
                self.fsync(f, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass  # best-effort temp cleanup; the original error propagates
            raise
        self.replace(tmp, path)


def _os_error(kind: str, op: str, path: str) -> OSError:
    if kind == "enospc":
        return DiskFaultError(errno.ENOSPC, f"injected ENOSPC: {op} {path}")
    return DiskFaultError(errno.EIO, f"injected EIO: {op} {path}")


#: process-wide seam instance; spawned dbnodes inherit a plan from the
#: env at import, tests swap one in with :func:`install_plan`
DISK = DiskIO(plan_from_env())


def install_plan(plan: DiskFaultPlan | None) -> None:
    DISK.plan = plan


# -- crash points --

# test hook: unit tests monkeypatch this to observe the trip without
# dying; spawned-process gates leave it as os._exit (a hard exit that
# skips atexit/finally — the closest in-process stand-in for SIGKILL)
_exit = os._exit


def armed_crash_points(env=None) -> frozenset:
    raw = (env if env is not None else os.environ).get(CRASH_POINT_ENV, "")
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def crash_point(site: str) -> None:
    """Hard-exit the process iff ``site`` is armed via env. Sites live at
    exact commit-protocol boundaries; the env read happens per call so a
    fixture can arm between restarts of the same process image."""
    if site in armed_crash_points():
        sys.stderr.write(f"CRASH_POINT {site}\n")
        sys.stderr.flush()
        _exit(CRASH_EXIT_CODE)
