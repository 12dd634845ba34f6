"""The port's span record: where the time of a training step, and of its
set-up, goes.

**Device spans.**  A train step (``trainer.train_step``,
``train_step_multicam`` and their data-parallel forms, each wrapped by
``step``) marks the boundaries of its stages on the device's clock.
``mark(name)`` writes a stamp into the next slot of a static int64
buffer: on the card the one-thread kernel ``csrc/span_mark.cu``
(``%globaltimer``, ns), on the CPU ``time.perf_counter_ns()``.  Each mark
opens a span named ``name`` and closes the one before it; the step's
last mark, after the update, only closes.  A mark of the name already
open is no new mark, and the first mark of a step names the span that
the step opened, so every kernel from the step's first to the update's
last falls in exactly one span.  The backward stages are marked by
``grad_mark``: an identity on a stage's outputs whose backward makes the
mark once their gradients are complete.  A mark made while a stream
captures a CUDA graph is a node of the graph and runs again on every
replay.  Marks are made only inside a step: a render called from
anywhere else marks nothing.

**Inner spans.**  A second level of marks times a stretch inside a
top-level span without moving any top-level stamp.  ``inner_mark(name)``
stamps now and opens the inner span ``name``, which closes at the next
top-level stamp; ``grad_inner_mark(name, *xs)`` is an identity whose
backward stamps once the gradients of ``xs`` are complete and closes
``name`` there, opened at the stamp of the top-level span then open.
Each inner span costs one ``span_mark``; its stamps live in the same
buffer, past the top-level slots.  The deformation field marks two
(``INNER_NAMES``): ``field.mlp.fwd``, from the hexplane query's return to
the next top-level mark, and ``field.mlp.bwd``, from the opening of
``field.bwd`` (the field's outputs have their gradients) to the moment
the hexplane's output has its gradient.

At the step's end, on the device, ``span_ns`` [len(NAMES)] int64 sums the
stamp differences of the spans by name (0 for a name the step did not
mark), ``inner_ns`` [len(INNER_NAMES)] int64 those of the inner spans;
beside them ``field_rows``, the rows entering the deformation field
(the pool's capacity, or the culled working set's size), and
``visible_rows``, those of them visible in at least one camera of the
step (both 0 in the coarse stage, which runs no field); and two tallies
(``TALLIES``) of the rasterizer: ``raster_passes``, the step's
``rasterize`` calls, and ``bins_reused``, those of them that took another
pass's binning.  The six are top-level keys of the step's aux and of its
``small_aux``.

**The traced window.**  ``trainer.scan_steps`` keeps a block's stacked
counters (``keep``) when a profiler is on at dispatch, and only then;
``traced_steps`` copies what was kept to the host when a reader asks.

**Host spans.**  ``host(name)``, a context manager or a decorator,
records a stretch of host work: its name, start and end on
``time.perf_counter_ns()`` and the enclosing host span's name as its
parent.  It also opens a ``torch.profiler.record_function`` range of the
name, so an exported trace shows the span on its host clock.  Records are
kept in memory, per process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# the stages of a step, in the order a step runs them
NAMES = ("cull", "field.fwd", "project.fwd", "bin.fwd", "composite.fwd",
         "loss.fwd", "loss.bwd", "composite.bwd", "bin.bwd", "project.bwd",
         "field.bwd", "allreduce", "update")
# stretches inside a top-level span, each timed by one more stamp
INNER_NAMES = ("field.mlp.fwd", "field.mlp.bwd")
TALLIES = ("raster_passes", "bins_reused")   # summed over a step's counts
KEYS = ("span_ns", "inner_ns", "field_rows", "visible_rows") + TALLIES
MAX_MARKS = 512          # top-level stamps a step, slots [0, MAX_MARKS)
MAX_INNER = 64           # inner stamps a step, the slots after them


_stamp_buffers: Dict[str, torch.Tensor] = {}
_matrices: Dict[Tuple[Any, ...], torch.Tensor] = {}


def _stamp_buffer(device: torch.device) -> torch.Tensor:
    """The device's static stamp buffer [MAX_MARKS + MAX_INNER] int64."""
    key = str(device)
    if key not in _stamp_buffers:
        _stamp_buffers[key] = torch.zeros(MAX_MARKS + MAX_INNER,
                                          dtype=torch.int64, device=device)
    return _stamp_buffers[key]


def _matrix(entries: Tuple[Tuple[int, int, int], ...], shape: Tuple[int, int],
            device: torch.device) -> torch.Tensor:
    """[rows, cols] int64, the sum of v at (row, col) over ``entries`` of
    (row, col, v).  Made by fills, no copy from the host; cached on the
    device for the mark sequence, except when made inside a capture (a
    captured fill runs only on replay)."""
    key = (entries, shape, str(device))
    m = _matrices.get(key)
    if m is None:
        m = torch.zeros(shape, dtype=torch.int64, device=device)
        for r, c, v in entries:
            m[r, c].add_(v)
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _matrices[key] = m
    return m


class StepRecord:
    """The marks of one step: ``names[i]`` names span i, from stamp i to
    stamp i + 1 of ``stamps``; ``inner[j]`` is inner span j, [name, its
    opening slot, its closing slot (None until the next top-level
    stamp)]."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stamps = _stamp_buffer(device)
        self.names: List[Optional[str]] = [None]
        self.inner: List[List[Any]] = []
        self.counts: Dict[str, Any] = {}
        self._stamp(0)

    def _stamp(self, slot: int) -> None:
        if self.stamps.device.type == "cuda":
            from s3gaussian_tpu_torch.ops import tile_kernels as tk
            tk.span_mark(self.stamps, slot)
        else:
            self.stamps[slot] = time.perf_counter_ns()

    def _top_stamp(self) -> int:
        """A top-level stamp, which closes every inner span still open."""
        slot = len(self.names)
        if slot >= MAX_MARKS:
            raise RuntimeError(f"a step of more than {MAX_MARKS} marks")
        self._stamp(slot)
        for span in self.inner:
            if span[2] is None:
                span[2] = slot
        return slot

    def _inner_stamp(self) -> int:
        if len(self.inner) >= MAX_INNER:
            raise RuntimeError(f"a step of more than {MAX_INNER} inner "
                               f"marks")
        slot = MAX_MARKS + len(self.inner)
        self._stamp(slot)
        return slot

    def mark(self, name: str) -> None:
        if self.names[-1] is None:
            self.names[-1] = name
        elif self.names[-1] != name:
            self._top_stamp()
            self.names.append(name)

    def inner_mark(self, name: str) -> None:
        """Open the inner span ``name`` here, up to the next top-level
        stamp."""
        self.inner.append([name, self._inner_stamp(), None])

    def inner_end(self, name: str) -> None:
        """Close the inner span ``name`` here, opened at the stamp of the
        top-level span now open."""
        self.inner.append([name, len(self.names) - 1, self._inner_stamp()])

    def close(self) -> Dict[str, torch.Tensor]:
        """The closing mark, then the step's counters, on the device."""
        k = self._top_stamp()
        # one signed selection over the stamps: span j of name i adds
        # stamp j + 1 and takes stamp j; an inner span of name i adds its
        # closing stamp and takes its opening one (row len(NAMES) + i)
        rows = [(NAMES.index(n), j + 1, j) for j, n in enumerate(self.names)]
        rows += [(len(NAMES) + INNER_NAMES.index(n), b, a)
                 for n, a, b in self.inner]
        width = MAX_MARKS + len(self.inner) if self.inner else k + 1
        sel = _matrix(tuple((r, c, v) for r, b, a in rows
                            for c, v in ((b, 1), (a, -1))),
                      (len(NAMES) + len(INNER_NAMES), width), self.device)
        ns = (sel * self.stamps[:width]).sum(1)
        span_ns, inner_ns = ns[:len(NAMES)], ns[len(NAMES):]
        vis = self.counts.get("visible")
        return {"span_ns": span_ns, "inner_ns": inner_ns,
                "visible_rows": (vis.sum(dtype=torch.int32)
                                 if vis is not None else
                                 torch.zeros((), dtype=torch.int32,
                                             device=self.device)),
                **{k: torch.full((), self.counts.get(k, 0),
                                 dtype=torch.int32, device=self.device)
                   for k in ("field_rows",) + TALLIES}}


_open: Optional[StepRecord] = None
_last: Optional[StepRecord] = None


def step(fn: Callable) -> Callable:
    """``fn``, a train step ``(state, view, ...) -> (state, aux)``, with
    its stages marked and the step's counters (``KEYS``) added to its
    aux.  A step called inside a step marks as part of the outer one."""

    @functools.wraps(fn)
    def marked(state, *args, **kw):
        global _open, _last
        if _open is not None:
            return fn(state, *args, **kw)
        rec = StepRecord(state.pool.xyz.device)
        _open = rec
        try:
            state, aux = fn(state, *args, **kw)
            counters = rec.close()
        finally:
            _open = None
        _last = rec
        return state, {**aux, **counters}

    return marked


def mark(name: str) -> None:
    """Open the span ``name`` in the step being run; nothing outside a
    step."""
    if _open is not None:
        _open.mark(name)


def count(**kw: Any) -> None:
    """Record the step's ``field_rows`` (an int) or its field rows'
    ``visible`` mask, or add to its ``TALLIES``; nothing outside a
    step."""
    if _open is not None:
        for k, v in kw.items():
            _open.counts[k] = (_open.counts.get(k, 0) + v if k in TALLIES
                               else v)


def inner_mark(name: str) -> None:
    """Open the inner span ``name`` in the step being run, up to its next
    top-level mark; nothing outside a step."""
    if _open is not None:
        _open.inner_mark(name)


class _GradMark(torch.autograd.Function):
    """The identity, whose backward calls ``fn``."""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.fn = fn
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.fn()
        return (None,) + grads


def _on_grads(fn: Callable[[], None], xs: Tuple[Optional[torch.Tensor], ...]
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """``xs`` through an identity whose backward calls ``fn`` once the
    gradients of all of them that require one are complete."""
    where = [i for i, x in enumerate(xs)
             if x is not None and x.requires_grad]
    if not where:
        return xs
    out = list(xs)
    for i, y in zip(where, _GradMark.apply(fn, *[xs[i] for i in where])):
        out[i] = y
    return tuple(out)


def grad_mark(name: str, *xs: Optional[torch.Tensor]
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """``xs`` unchanged; inside a step, through an identity whose backward
    marks ``name`` when the gradients of all of them are complete (a
    None passes through)."""
    if _open is None:
        return xs
    return _on_grads(functools.partial(_open.mark, name), xs)


def grad_inner_mark(name: str, *xs: Optional[torch.Tensor]
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """``xs`` unchanged; inside a step, through an identity whose backward
    closes the inner span ``name`` when the gradients of all of them are
    complete, opened at the stamp of the top-level span then open."""
    if _open is None:
        return xs
    return _on_grads(functools.partial(_open.inner_end, name), xs)


def last_marks() -> Tuple[str, ...]:
    """The span names of the last step run on the host, in order (a
    replayed step's are those of its capture)."""
    return tuple(_last.names) if _last is not None else ()


def last_inner() -> Tuple[str, ...]:
    """The inner span names of the last step run on the host, in order:
    one ``span_mark`` each, beside the top-level marks' len(last_marks())
    + 1."""
    return tuple(s[0] for s in _last.inner) if _last is not None else ()


def last_stamps() -> Optional[torch.Tensor]:
    """The stamps of the last step run on the host, a view of the stamp
    buffer (the next step overwrites it)."""
    if _last is None:
        return None
    return _last.stamps[:len(_last.names) + 1]


_traced: List[Dict[str, torch.Tensor]] = []


def keep(aux: Dict[str, Any]) -> None:
    """Keep a block's stacked counters (those of ``KEYS`` it has), on
    their device."""
    _traced.append({k: aux[k] for k in KEYS if k in aux})


def traced_steps() -> Optional[Dict[str, torch.Tensor]]:
    """Every kept step's counters on the host (``span_ns`` [S,
    len(NAMES)], ``inner_ns`` [S, len(INNER_NAMES)], ``field_rows``,
    ``visible_rows`` and the ``TALLIES`` [S], int64; a counter only where
    every kept block has it), or None when nothing was kept."""
    if not _traced:
        return None
    return {k: torch.cat([b[k].to("cpu", torch.int64) for b in _traced])
            for k in KEYS if all(k in b for b in _traced)}


def step_ms(ns: torch.Tensor, names: Tuple[str, ...] = NAMES
            ) -> Dict[str, float]:
    """A step's milliseconds by span name (of ``span_ns``, or of
    ``inner_ns`` with ``INNER_NAMES``), the names it marked."""
    return {n: v / 1e6 for n, v in zip(names, ns.tolist()) if v > 0}


def step_line(aux: Dict[str, Any]) -> str:
    """One step's spans, inner spans and field rows as the CLI prints
    them beside its logger entry."""
    def listed(ms):
        return ", ".join(f"{n} {v:.3f}" for n, v in ms.items())

    line = f"spans (ms): {listed(step_ms(aux['span_ns']))}"
    inner = step_ms(aux["inner_ns"], INNER_NAMES) if "inner_ns" in aux else {}
    if inner:
        line += f"; inside them {listed(inner)}"
    rows, vis = int(aux["field_rows"]), int(aux["visible_rows"])
    if rows:
        line += (f"; visible rows / field rows {vis} / {rows} "
                 f"({100.0 * vis / rows:.2f}%)")
    return line


@dataclasses.dataclass
class HostSpan:
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: Optional[int] = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_host: List[HostSpan] = []
_host_open: List[HostSpan] = []


@contextlib.contextmanager
def host(name: str):
    """A host span around the block (or the decorated function); yields
    its ``HostSpan``, whose ``ms`` holds once the block has ended."""
    span = HostSpan(name, _host_open[-1].name if _host_open else None,
                    time.perf_counter_ns())
    _host.append(span)
    _host_open.append(span)
    try:
        with torch.profiler.record_function(name):
            yield span
    finally:
        span.end_ns = time.perf_counter_ns()
        _host_open.pop()


def host_spans(name: Optional[str] = None) -> List[HostSpan]:
    """The ended host spans, in the order they started (those of
    ``name`` only, when given)."""
    return [s for s in _host if s.end_ns is not None
            and (name is None or s.name == name)]


def host_line() -> str:
    """The ended host spans as the CLI prints them after its set-up."""
    return "host spans (s): " + ", ".join(
        f"{s.name} {s.ms / 1e3:.3f}" for s in host_spans())


def reset() -> None:
    """Forget every kept block and host span."""
    _traced.clear()
    _host.clear()
