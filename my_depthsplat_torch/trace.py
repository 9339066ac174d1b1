"""Spans of the port's layers, read from a ``torch.profiler`` trace.

``span(name)`` marks a region of the program by a dotted name,
``<layer>.<part>`` (``unimatch.sweep``, ``render.bin``, ``train.backward``),
so that it never clashes with the undotted names a caller gives its own
regions. While a ``torch.profiler`` profile records, it is
``torch.profiler.record_function(name)``: a ``user_annotation`` event on the
profiler's host clock, the clock on which the trace also lays out the
device's kernels and copies, each joined to the runtime call that launched
it. A reader of the exported trace can so put each device operation down to
the innermost span open where it was launched, with no clock of its own
(``portbench/spans.py`` does). A span opened inside a backward function
runs on autograd's thread.

Otherwise ``span`` returns one shared null context after one flag read.
On or off it allocates no tensor and never synchronises; this module keeps
no store: the profiler holds the events and writes them out.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around a region of the program: a profiler
    annotation named ``name`` while a profile records, else a null
    context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
