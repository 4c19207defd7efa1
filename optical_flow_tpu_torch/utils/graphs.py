"""CUDA graphs of the level step's plain-op chains.

A level step of the BA and Classic+NL families (``methods/ba.py``,
``methods/classic_nl.py``) issues some 1,500 small plain ops a level: the
warp tables, the warped derivatives, the two IRLS systems and their blend,
the occlusion map, the guard.  Issued one by one from Python, they make the
host, not the card, pace the coarse levels.  :func:`run` captures each such
chain once as a CUDA graph and then replays it: a chain costs a few host
calls where it cost hundreds.  The kernels and their bits are the same.

Only what is handed to :func:`run` is captured.  The PCG solve, the
weighted median, the plain median and the glue between the chains stay
eager, so each hand-written kernel keeps its own launch, counters and
profiler ranges, and the cooperative launches stay out of stream capture.

* **Key**: the chain, the GNC stage and pyramid level (:func:`level`, which
  the flow programs and the warm-up open; None outside them), B, H, W, the
  device, and the chain's configuration: its static arguments (the level's
  frozen config), the structure, shapes and dtypes of its inputs and the
  float32 matmul settings.
* **Policy**: the first sight of a key runs the chain eagerly, which builds
  the lazily cached device constants (their first build is a pageable
  copy, which capture refuses), then captures it on a stream of its own and
  replays the graph; every later sight only replays.  So a flow's first call of a shape makes every capture and its
  later calls replay.  A chain runs eagerly on CPU tensors, on any dtype but
  float32, on tensors that need gradients, inside a mesh's level
  (:func:`level` with ``graphed=False``) and inside a capture of the
  caller's.
* **Inputs and outputs** live in slots of an arena of device memory.  An
  input is copied into its slot, which keeps the input's strides, unless
  it already is a slot or another graph's output: a chain fed by another chain (the warp tables into the
  derivatives into the system) copies nothing.  Each graph ends by copying
  its outputs into its output slots, so its private pool holds only its
  temporaries.  The outputs are overwritten by the next replay: none may
  leave the level step (the caller's flow is eager; ``fresh=True`` returns
  copies).  So no two level steps are live at once, and each lays its slots
  out from the arena's start.  A level step's slots stay its own, so a step
  may mix graphs captured in different calls (two configurations that share
  a chain): none writes where another's live data is.
* **Memory**: one private pool and one arena a call shape, for each device
  and thread; :data:`MAX_CALL_SHAPES` call shapes are kept, least recently
  used first out.
* **Counters**: :func:`stats` counts the chain runs of each device that
  captured, replayed or ran eagerly; :func:`reset_stats` zeroes them.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import NamedTuple, Optional

import torch

from optical_flow_tpu_torch.utils.profiling import annotate

MAX_CALL_SHAPES = 4  # call shapes whose graphs a device and thread keep
_ALIGN = 512  # bytes: a slot starts where the caching allocator would start a block
_CHUNK_MAX = 256 << 20  # bytes: arena chunks are up to 8 slots and at most this, unless one slot is larger


class ChainKey(NamedTuple):
    """What a chain's graph is kept under."""

    chain: str
    stage: Optional[int]
    level: Optional[int]
    B: int
    H: int
    W: int
    device: str
    config: tuple


def _flatten(x, leaves: list):
    """A hashable spec of ``x``, nested tuples, lists and NamedTuples of tensors and
    constants; its tensors are appended to ``leaves`` (None marks one in the spec)."""
    if torch.is_tensor(x):
        leaves.append(x)
        return None
    if isinstance(x, (tuple, list)):
        return type(x), tuple(_flatten(v, leaves) for v in x)
    return "const", x


def _unflatten(spec, leaves):
    """The inverse of :func:`_flatten`, reading tensors from the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    kind, body = spec
    if kind == "const":
        return body
    items = [_unflatten(s, leaves) for s in body]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


class _Call:
    """The graphs of one call shape on one device, their private pool and their arena."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None  # the private pool of its graphs' temporaries, made at the first capture
        self.graphs = {}
        self.static = set()  # ids of every slot and output of the graphs, held alive by them
        self.chunks = []  # the arena: uint8 tensors
        self.used = {}  # level step -> bytes its slots take in each chunk

    def slot(self, step, like):
        """A tensor of ``like``'s shape, dtype and, where they are dense, strides in
        the arena, apart from every other slot of the level step ``step``.  The
        strides matter: a flow's components are planes, and ops on strided
        components leave the vectorised kernels."""
        strides = torch.empty_like(like, device="meta").stride()
        nbytes = like.numel() * like.element_size()
        used = self.used.setdefault(step, [])
        used += [0] * (len(self.chunks) - len(used))
        for i, chunk in enumerate(self.chunks):
            if used[i] + nbytes <= chunk.numel():
                break
        else:
            size = max(nbytes, min(8 * nbytes, _CHUNK_MAX))
            self.chunks.append(torch.empty(size, dtype=torch.uint8, device=self.device))
            used.append(0)
            i = len(self.chunks) - 1
        start = used[i]
        used[i] = start + -(-nbytes // _ALIGN) * _ALIGN
        out = self.chunks[i][start:start + nbytes].view(like.dtype).as_strided(like.shape, strides)
        self.static.add(id(out))
        return out


class _Graph:
    __slots__ = ("graph", "inputs", "out", "out_spec", "out_leaves")


class _State(threading.local):
    def __init__(self):
        self.where = (None, None, None, True)  # call shape, stage, level, graphed
        self.calls = collections.OrderedDict()  # (device, call shape) -> _Call
        self.side = {}  # device -> the capture stream


_state = _State()
_stats = collections.defaultdict(collections.Counter)


@contextlib.contextmanager
def level(call, stage: int, level: int, graphed: bool = True):
    """Within the block, the chains belong to GNC stage ``stage`` and pyramid
    level ``level`` of a call of shape ``call`` (its B, H, W); with
    ``graphed=False`` (a mesh's level) they run eagerly."""
    saved = _state.where
    _state.where = (call, stage, level, graphed)
    try:
        yield
    finally:
        _state.where = saved


def _graphable(leaves, graphed: bool) -> bool:
    if not graphed or not leaves:
        return False
    dev = leaves[0].device
    if dev.type != "cuda":
        return False
    if any(t.device != dev or t.dtype != torch.float32 or t.requires_grad for t in leaves):
        return False
    return not torch.cuda.is_current_stream_capturing()


def chain_key(chain: str, static, args) -> ChainKey:
    """The key of ``run(span, chain, fn, static, *args)`` in the current :func:`level`."""
    leaves = []
    spec = _flatten(tuple(args), leaves)
    return _key(chain, static, args[0], spec, leaves)


def _key(chain, static, first, spec, leaves) -> ChainKey:
    call, stage, lvl, _ = _state.where
    shape = first.shape
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    signature = tuple((tuple(t.shape), t.dtype) for t in leaves)
    return ChainKey(chain, stage, lvl, math.prod(shape[:-3]), shape[-3], shape[-2], str(first.device),
                    (static, spec, signature, flags))


def _group(device: torch.device) -> _Call:
    """The current call shape's graphs on ``device``, most recently used now."""
    key = (str(device), _state.where[0])
    calls = _state.calls
    group = calls.get(key)
    if group is None:
        while len(calls) >= MAX_CALL_SHAPES:
            _, old = calls.popitem(last=False)
            torch.cuda.synchronize(old.device)  # its replays are done before its memory goes
        group = calls[key] = _Call(device)
    else:
        calls.move_to_end(key)
    return group


def _side_stream(device: torch.device):
    """The capture stream, its library handles and workspaces made before its first capture."""
    if device not in _state.side:
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            torch.ones(2, 2, device=device) @ torch.ones(2, 2, device=device)
        _state.side[device] = side
    return _state.side[device]


def _capture(group: _Call, key: ChainKey, fn, static, args, spec, leaves) -> _Graph:
    """Run ``fn`` eagerly, capture it on the capture stream on slots holding ``leaves``, and keep the graph."""
    step = key[1:6]  # stage, level, B, H, W
    inputs = []
    for x in leaves:
        if id(x) in group.static:
            inputs.append(x)
        else:
            inputs.append(group.slot(step, x))
            inputs[-1].copy_(x)
    cur, side = torch.cuda.current_stream(), _side_stream(group.device)
    warm = fn(*static, *args)  # builds what the chain builds lazily; its result is not used
    warm_leaves = []
    out_spec = _flatten(warm, warm_leaves)
    # an output that shares an input's storage is a view of the input's slot in the capture
    in_storage = {x.untyped_storage().data_ptr() for x in leaves}
    out_slots = [None if w.untyped_storage().data_ptr() in in_storage else group.slot(step, w)
                 for w in warm_leaves]
    del warm, warm_leaves
    side.wait_stream(cur)
    if group.pool is None:
        group.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=group.pool, capture_error_mode="thread_local")
        try:
            out_leaves = []
            _flatten(fn(*static, *_unflatten(spec, iter(inputs))), out_leaves)
            for o, s in zip(out_leaves, out_slots):
                if s is not None:
                    s.copy_(o)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    g = _Graph()
    g.graph, g.inputs, g.out_spec = graph, inputs, out_spec
    g.out_leaves = [o if s is None else s for o, s in zip(out_leaves, out_slots)]
    g.out = _unflatten(out_spec, iter(g.out_leaves))
    group.static.update(id(o) for o in g.out_leaves)
    group.graphs[key] = g
    return g


def run(span: str, chain: str, fn, static: tuple, *args, fresh: bool = False):
    """``fn(*static, *args)``: the chain ``chain`` inside the span ``span``
    (attribute ``graph``: ``"eager"``, ``"capture"`` or ``"replay"``), from
    its CUDA graph where one applies (see the module docstring).

    ``args[0]`` is a (..., H, W, C) tensor, whose shape names the level;
    ``static`` holds the chain's hashable constants, which are part of its
    key.  A graph returns its output slots, which its next replay
    overwrites; ``fresh=True`` returns copies, for a result that leaves the
    level step.
    """
    leaves = []
    spec = _flatten(args, leaves)
    device = leaves[0].device if leaves else torch.device("cpu")
    if not _graphable(leaves, _state.where[3]):
        _stats[str(device)]["eager"] += 1
        with annotate(span, graph="eager"):
            return fn(*static, *args)
    key = _key(chain, static, args[0], spec, leaves)
    group = _group(device)
    g = group.graphs.get(key)
    mode = "capture" if g is None else "replay"
    with annotate(span, graph=mode), torch.cuda.device(device):
        if g is None:
            g = _capture(group, key, fn, static, args, spec, leaves)
        else:
            for x, s in zip(leaves, g.inputs):
                if x is not s:
                    s.copy_(x)
        g.graph.replay()
        _stats[str(device)]["captures" if mode == "capture" else "replays"] += 1
        if fresh:
            return _unflatten(g.out_spec, iter([o.clone() for o in g.out_leaves]))
        return g.out


def _device_name(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def stats(device=None) -> dict:
    """The chain runs since :func:`reset_stats` on ``device`` (every device if
    None): ``captures``, ``replays``, ``eager`` and ``hit_share``, replays over
    all three (None before any run)."""
    if device is None:
        counts = sum(_stats.values(), collections.Counter())
    else:
        counts = _stats.get(_device_name(device), collections.Counter())
    out = {k: int(counts[k]) for k in ("captures", "replays", "eager")}
    total = sum(out.values())
    out["hit_share"] = out["replays"] / total if total else None
    return out


def reset_stats():
    _stats.clear()
