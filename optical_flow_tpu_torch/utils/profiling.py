"""Tracing and stage timing on ``torch.profiler`` (port of ``optical_flow_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` over the CPU
  and, where there is one, the GPU, writing a Chrome / Perfetto trace
  (``trace.json``) under ``logdir``;
* :func:`annotate`: the port's span, ``oftpu.<name>`` in that trace, with
  an in-memory record of its attributes (:func:`span_records`); it costs one
  flag check while no profiler records;
* :class:`StageTimer`: host-clock stage timing that synchronises the
  device of the result before it reads the clock, with the JAX package's
  totals and report.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "oftpu."


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace goes to ``logdir/trace.json`` (Chrome trace
    format, viewable in Perfetto).  Yields the profiler; the device is
    synchronised at the block's end, so its kernels are in the trace.  The
    span records start anew, so :func:`span_records` describes this block."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    clear_span_records()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()
_records: List[dict] = []


@contextlib.contextmanager
def _span(name: str, attrs: dict):
    with torch.profiler.record_function(SPAN_PREFIX + name):
        _records.append({"name": name, "attrs": attrs})
        yield


def annotate(name: str, **attrs):
    """The port's span: ``oftpu.<name>`` in the trace of a recording
    ``torch.profiler`` session (the flag ``record_function`` itself reads),
    on the profiler's clock, so each device operation ties to its innermost
    span by its launch's correlation id.

    While a profiler records, each span also appends a record of its name
    and ``attrs``: the k-th record is the trace's k-th ``oftpu.*`` event in
    start order, since the trace drops ``record_function``'s arguments.
    While none records, a span is one flag check and the shared null
    context: it records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _span(name, attrs)


def span_records() -> List[dict]:
    """The records of the spans made while a profiler recorded, in start
    order, since the last :func:`trace` began or :func:`clear_span_records`."""
    return list(_records)


def clear_span_records():
    _records.clear()


def _synchronize(sync):
    """Wait for the device work behind ``sync``: a tensor, or a tuple or list of them."""
    for t in sync if isinstance(sync, (tuple, list)) else (sync,):
        if torch.is_tensor(t) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class StageTimer:
    """Host-side stage timer that synchronizes the device per stage.

    Example:
        timer = StageTimer()
        with timer.stage("pyramid", sync=images):
            pyr = build_pyramid(images, ...)
        print(timer.report())

    ``sync``: a tensor, or a tuple or list of them; the device of each CUDA
    one is synchronised when the stage ends, so the time covers the work the
    stage queued there.
    """

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.records.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        width = max((len(n) for n in totals), default=4)
        lines = [f"{n:<{width}}  {dt * 1000:9.2f} ms" for n, dt in totals.items()]
        return "\n".join(lines)
