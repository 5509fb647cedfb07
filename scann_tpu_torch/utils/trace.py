"""Named spans around the stages of a search, for ``torch.profiler``.

``with span("tree_ah.leaf"): ...`` marks the code inside as one stage in
any profiler trace taken around it (``torch.profiler.profile``, or the ANN
harness's ``--profile-dir``): the span is the profiler's own user
annotation (``record_function``), on the clock of its host and device
events, and every kernel, copy and fill that the code enqueues falls
inside it on the host.

With no profiler running, ``span`` reads one flag and returns a shared
no-op context: ``record_function`` is not called, since it costs a
dispatcher call even when nothing records it.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context marking ``name`` in the running profiler's trace; the
    shared no-op context when no profiler runs."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
