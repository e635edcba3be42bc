"""The reserved self-monitoring namespace rule.

A copy of the check in ``m3_tpu/selfmon/guard.py``: every ``_m3tpu*``
namespace is reserved for the node's own telemetry, and ``Database.write``
/ ``write_batch`` refuse a write into one unless the calling thread is
inside :func:`selfmon_writer`. The collector, the ruler's writer context
and the wire marker wait for ROADMAP §A10.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

# the reserved namespace PREFIX: "_m3tpu" itself is the default namespace
# the collector writes; any "_m3tpu*" name is covered by the rule
RESERVED_NS = "_m3tpu"


class ReservedNamespaceError(ValueError):
    """A non-collector write targeted the reserved self-monitoring
    namespace."""


_local = threading.local()


def is_reserved(namespace: str) -> bool:
    return str(namespace).startswith(RESERVED_NS)


def writer_active() -> bool:
    """Whether this thread is inside a selfmon writer context."""
    return getattr(_local, "depth", 0) > 0


@contextmanager
def selfmon_writer():
    """Declare self-monitoring write intent for the current thread."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def check_write(namespace: str) -> None:
    """Runtime assertion for the reserved-namespace rule; called by the
    ``storage.Database`` write paths on every write. Non-reserved
    namespaces cost one string prefix check."""
    if is_reserved(namespace) and not writer_active():
        raise ReservedNamespaceError(
            f"write into reserved self-monitoring namespace {namespace!r} "
            "from a non-collector path (wrap in selfmon.guard."
            "selfmon_writer() only if you ARE the self-scrape pipeline)"
        )
