"""The launch parameters a step's kernels run with, recorded at capture.

A CUDA graph replays the launches it captured, so which schedule a
captured step runs is fixed at its capture.  While
:class:`~repro_torch.serving.captured.CapturedStep` captures a step it
opens :func:`recording`; every wrapper that launches a kernel inside it
notes its kind and launch parameters (block sizes, the decode split)
with :func:`note`, and the step keeps the distinct entries.  Outside a
recording :func:`note` does nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, List, Optional

_LOG: contextvars.ContextVar[Optional[List[Dict[str, Any]]]] = \
    contextvars.ContextVar("repro_torch_launch_log", default=None)


@contextlib.contextmanager
def recording() -> Iterator[List[Dict[str, Any]]]:
    """Collect the distinct launch parameters noted inside the block."""
    log: List[Dict[str, Any]] = []
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def note(kind: str, **params: Any) -> None:
    """Record one launch's parameters if a recording is open."""
    log = _LOG.get()
    if log is not None:
        entry = {"kind": kind, **params}
        if entry not in log:
            log.append(entry)


__all__ = ["recording", "note"]
