"""Deadline bookkeeping: the caller's propagated deadline.

The deadline part of ``m3_tpu/net/resilience.py``, copied: an entry point
that knows how long its caller will wait establishes an ambient MONOTONIC
deadline (``deadline_scope``), and work that queues reads it
(``current_deadline``; the query engine bounds its admission wait with it),
so nothing keeps working for a caller that already hung up. The retry
budgets, circuit breakers and health probes of that module serve the RPC
plane and wait for it (ROADMAP §A10).
"""

from __future__ import annotations

import threading
import time


class DeadlineExceededError(RuntimeError):
    """The caller's deadline expired before (or while) the call ran."""


_DEADLINE_LOCAL = threading.local()


def current_deadline() -> float | None:
    """This thread's ambient deadline as a MONOTONIC instant, or None.

    Established by :func:`deadline_scope` at an entry point that knows
    how long its caller is willing to wait (the coordinator's HTTP
    ``timeout`` param / ``M3-Timeout`` header); consumed wherever work
    queues or fans out (``QueryScheduler.admit(deadline=)``, the RPC
    client's per-call wall-clock budget) so nothing keeps working for a
    caller that already hung up."""
    return getattr(_DEADLINE_LOCAL, "deadline", None)


def remaining_time() -> float | None:
    """Seconds until the ambient deadline (may be <= 0 when already
    expired), or None when no deadline scope is active."""
    deadline = current_deadline()
    if deadline is None:
        return None
    return deadline - time.monotonic()


class deadline_scope:
    """Establish (or tighten) the thread's ambient deadline for a block.

    Scopes only ever TIGHTEN: nesting under an earlier scope keeps the
    earlier deadline when it is sooner, so an inner library cannot grant
    itself more time than the caller offered. ``None`` is a no-op scope
    (keeps whatever is ambient), which lets entry points write
    ``with deadline_scope(parsed_or_none):`` unconditionally. Re-enter
    with a captured :func:`current_deadline` value to carry the budget
    onto a worker thread (thread-locals don't cross threads)."""

    def __init__(self, deadline: float | None) -> None:
        self.deadline = deadline
        self._prev: float | None = None

    def __enter__(self) -> float | None:
        self._prev = getattr(_DEADLINE_LOCAL, "deadline", None)
        if self.deadline is None:
            effective = self._prev
        elif self._prev is None:
            effective = self.deadline
        else:
            effective = min(self._prev, self.deadline)
        _DEADLINE_LOCAL.deadline = effective
        return effective

    def __exit__(self, *exc) -> None:
        _DEADLINE_LOCAL.deadline = self._prev
