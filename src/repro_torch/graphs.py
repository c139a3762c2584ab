"""CUDA graphs for the port's compiled programs: the port's counterpart of
jax.jit, shared by the planner engine (planning/programs.py), the serve
steps (runtime/serve.py: jit_prefill, jit_decode_step,
jit_masked_decode_step) and the online loop's epoch and fallback plan
(online/loop.py).

A capture records the launches of a function on a stream without running
them; a replay runs them again on whatever the captured tensors then hold.
So a program keeps static buffers for its operands, copies each call's
operands into them, and replays. Python runs only at capture: Python floats
are baked in, and Python counters do not run on a replay. ``capture``
therefore records what the captured launches added to every counter dict
of the package (the kernels' LAUNCHES and flash_attention.SHAPES, the
COUNTS of li_gd, baselines, the loop and the server), takes it back (a
capture launches nothing), and each replay adds it again. The MoE dispatch
appends its dropped-slot count to ``models.moe.drop_log``; a capture keeps
those counts (tensors its graph rewrites) and each replay appends copies
of them taken after it, so a drop log never holds a stale count.

A capture that fails raises; nothing runs eagerly in its place. The
collector waits while a stream captures: collecting a dead program (one
left in a reference cycle) destroys its graphs, which the CUDA runtime
refuses during a capture, and the capture would fail.

Three checks of a program against its eager run, shared by the card tests
and chip_smoke.py: ``differing`` (the tensor leaves of two trees that are
not equal to the bit), ``blocking_syncs`` (the blocking host syncs a call
makes) and ``traced_launches`` (the port's kernels that a call ran on the
device, read off a torch.profiler trace: the count a replay's bookkeeping
is held to).
"""
from __future__ import annotations

import collections
import gc
import re
import time
import warnings
from pathlib import Path

import torch

from repro_torch.core.types import Tensor, tree_map


def counters() -> tuple[dict, ...]:
    """Every Python counter dict of the package that code inside a graph
    could add to."""
    from repro_torch.core import baselines, li_gd
    from repro_torch.kernels import flash_attention, noma_rates, rg_lru
    from repro_torch.online import loop
    from repro_torch.runtime import serve
    return (noma_rates.LAUNCHES, flash_attention.LAUNCHES, flash_attention.SHAPES,
            rg_lru.LAUNCHES, li_gd.COUNTS, baselines.COUNTS, loop.COUNTS, serve.COUNTS)


class Graph:
    """A captured CUDA graph, what its capture added to the counters, the
    MoE drop counts it computes, and its outputs (the tensors its last
    replay wrote)."""

    def __init__(self, graph, added: list, out, drops: list):
        self.graph, self.added, self.out, self.drops = graph, added, out, drops

    def replay(self) -> None:
        self.graph.replay()
        for counter, added in self.added:
            for k, v in added.items():
                counter[k] = counter.get(k, 0) + v
        if self.drops:
            from repro_torch.models import moe
            moe.log_drops([d.clone() for d in self.drops])


def static_like(x: Tensor, device: torch.device) -> Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=device)


def check_like(bufs: list, leaves: list, what: str) -> None:
    for i, (b, x) in enumerate(zip(bufs, leaves)):
        if tuple(b.shape) != tuple(x.shape) or b.dtype != x.dtype:
            raise ValueError(f"{what} {i} is {tuple(x.shape)}/{x.dtype} but the program was "
                             f"built for {tuple(b.shape)}/{b.dtype}")


def capture(fn, pool) -> tuple[Graph, float]:
    """Capture fn() on the current stream into ``pool``. Returns the Graph
    and the host seconds the capture took."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    kept = counters()
    before = [dict(c) for c in kept]
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    # thread_local: another thread (a snapshot writer) may use the CUDA
    # runtime while this one captures.
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        with moe.drop_log() as drops:
            out = fn()
    finally:
        graph.capture_end()
        if collecting:
            gc.enable()
    added = []
    for c, b in zip(kept, before):
        diff = {k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
        c.clear()
        dict.update(c, b)
        if diff:
            added.append((c, diff))
    return Graph(graph, added, out, list(drops)), time.perf_counter() - t0


def tensors(tree) -> list[Tensor]:
    """The tensors of a tree in tree_map's order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def copy_into(dst: list, src: list) -> None:
    """dst[i].copy_(src[i]) for every pair whose tensors are not the same
    object, in one foreach launch where the backend has one."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def fresh(tree):
    """tree with every tensor leaf cloned (one foreach copy)."""
    src = tensors(tree)
    dst = [torch.empty_like(x) for x in src]
    copy_into(dst, src)
    it = iter(dst)
    return tree_map(lambda _: next(it), tree)


def differing(a, b) -> list:
    """Indices of the tensor leaves of two trees that differ (dtype, shape
    or value; NaN equal to NaN); ["structure"] if their leaf counts
    differ."""
    la, lb = tensors(a), tensors(b)
    if len(la) != len(lb):
        return ["structure"]
    bad = []
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(i)
            continue
        same = x == y
        if x.is_floating_point():
            same = same | (torch.isnan(x) & torch.isnan(y))
        if not bool(same.all()):
            bad.append(i)
    return bad


SYNC_WARNING = "called a synchronizing CUDA operation"   # set_sync_debug_mode's


def blocking_syncs(fn, inside=()):
    """fn() under torch.cuda.set_sync_debug_mode("warn"). Returns its
    result, the blocking syncs made while one of the ``inside`` methods
    ((class, name) pairs, e.g. (Compiled, "__call__"): a program call)
    ran, and a Counter of where the others were made (file:line)."""
    depth, n_inside, where = [0], [0], collections.Counter()
    saved = [(owner, name, getattr(owner, name)) for owner, name in inside]

    def counted(orig):
        def call(*a, **k):
            depth[0] += 1
            try:
                return orig(*a, **k)
            finally:
                depth[0] -= 1
        return call

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return       # the mode's one-time prototype notice, say
        if depth[0]:
            n_inside[0] += 1
        else:
            where[f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        for owner, name, orig in saved:
            setattr(owner, name, counted(orig))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            for owner, name, orig in saved:
                setattr(owner, name, orig)
    return out, n_inside[0], where


# The device symbol of each hand-written kernel, by the LAUNCHES key its
# wrapper counts it under.
KERNEL_SYMBOLS = (("flash_wgmma_kernel", "flash_attention"),
                  ("flash_f32_kernel", "flash_attention"),
                  ("cell_intra_dense_kernel", "noma_cell_intra"),
                  ("cell_intra_kernel", "noma_cell_intra"),
                  ("per_ap_kernel", "noma_per_ap"),
                  ("ap_contract_kernel", "noma_ap_contract"),
                  ("rg_lru_kernel", "rg_lru"))


def traced_launches(fn):
    """fn() under torch.profiler: its result and kernel_launches of the
    trace. fn's work is waited for."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, kernel_launches(prof)


def kernel_launches(prof) -> dict:
    """The launches of the port's kernels that a finished torch.profiler
    profile holds, by LAUNCHES key (every key, zeros included). The count
    is read off the device's kernel records, not the wrappers' counters,
    so it covers the kernels a graph replay runs."""
    from torch.autograd import DeviceType
    counts = {key: 0 for _, key in KERNEL_SYMBOLS}
    pats = [(re.compile(rf"(?<![A-Za-z_]){sym}(?![a-z0-9_])"), key)
            for sym, key in KERNEL_SYMBOLS]
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for pat, key in pats:
            if pat.search(e.key):
                counts[key] += e.count
                break
    return counts


def _unalias(tree, bufs: list):
    """tree with the leaves that share storage with ``bufs`` (the static
    operands, which the next call overwrites) cloned."""
    held = {b.untyped_storage().data_ptr() for b in bufs if b.numel()}

    def own(x):
        if x.numel() and x.untyped_storage().data_ptr() in held:
            return x.clone()
        return x
    return tree_map(own, tree)


class Compiled:
    """``fn(static)`` over static copies of its operands, one CUDA graph per
    key: the kind's program, as jax.jit compiles a function once per
    abstract signature.

    Called with a tree of operands (dicts, tuples, NamedTuples and
    dataclasses over tensors; other leaves pass through as they are) and an
    optional hashable ``key`` for what else a capture bakes in (a module
    default, Python constants). The program's key is that plus every
    tensor operand's shape and dtype; a new key builds (it records ``kind``
    in planning.compile_log) and allocates static buffers for it. Each call
    copies its operands into the key's buffers (an operand that *is* its
    buffer is not copied) and calls fn on them:

    * on the card, the first call on a key runs fn eagerly (the call's
      result, and the warm-up: libraries load and allocate) and then
      captures it from the live buffers, which runs nothing; every later
      call replays the graph and returns fresh copies of its outputs. The
      program captures and replays on a stream of its own, into a memory
      pool of its own;
    * on the CPU fn runs eagerly on the buffers every call.

    Outputs never alias the static buffers: an output that is an operand
    buffer (a pass-through) is cloned. fn may also write into its operand
    buffers in place (a decode step's caches); the caller reads them back
    through ``operands``, the static operand tree of the last call.

    ``adopt`` names top-level entries of a dict of operands (a decode
    step's "caches") whose tensors become the key's buffers on its first
    call, with no allocation and no copy: fn then writes the caller's
    tensors in place, as a donated buffer is reused. Later calls that pass
    the same tensors copy nothing; other tensors are copied into the
    adopted ones. Two programs that adopt the same tensors (a batcher's
    admission and its masked step) share them.

    ``release()`` drops every graph and buffer, so their memory can go back
    to the card; ``eager()`` is a stand-in that calls fn on the operands
    as they are (the reference a compiled run is held to)."""

    def __init__(self, kind: str, fn, device: torch.device, adopt=()):
        self.kind, self.fn, self.device = kind, fn, torch.device(device)
        self._adopt = tuple(adopt)
        self._graphed = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._graphed else None
        self._pool = torch.cuda.graph_pool_handle() if self._graphed else None
        self._bufs: dict = {}      # key -> static operand buffers (tensors())
        self._graphs: dict = {}    # key -> Graph
        self.capture_s = 0.0       # host seconds spent capturing
        self.operands = None       # the static operand tree of the last call

    @property
    def pool(self):
        return self._pool

    @property
    def graph_count(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        return list(self._bufs)

    def release(self) -> None:
        self._graphs.clear()
        self._bufs.clear()
        self.operands = None

    def eager(self):
        return Eager(self.fn)

    @torch.no_grad()
    def __call__(self, inputs, key=()):
        from repro_torch.planning.programs import record
        leaves = tensors(inputs)
        k = (key, tuple((tuple(x.shape), x.dtype) for x in leaves))
        bufs = self._bufs.get(k)
        if bufs is None:
            record(self.kind)
            held = {id(x) for name in self._adopt for x in tensors(inputs.get(name))}
            bufs = self._bufs[k] = [x if id(x) in held and x.device == self.device
                                    else static_like(x, self.device) for x in leaves]
        if not self._graphed:
            copy_into(bufs, leaves)
            self.operands = static = self._static(inputs, bufs)
            return _unalias(self.fn(static), bufs)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            copy_into(bufs, leaves)
            self.operands = static = self._static(inputs, bufs)
            graph = self._graphs.get(k)
            if graph is None:
                out = _unalias(self.fn(static), bufs)
                graph, secs = capture(lambda: self.fn(static), self._pool)
                self._graphs[k] = graph
                self.capture_s += secs
            else:
                graph.replay()
                out = fresh(graph.out)
        caller.wait_stream(self._stream)
        # Made on the program's stream, used on the caller's: their memory
        # is not reused before the caller's work on them is done.
        for t in tensors(out):
            t.record_stream(caller)
        return out

    @staticmethod
    def _static(inputs, bufs: list):
        it = iter(bufs)
        return tree_map(lambda _: next(it), inputs)


class Eager:
    """Stands in for a Compiled program: fn on the operands as they are,
    every call (no buffers, no graph)."""

    def __init__(self, fn):
        self.fn = fn

    @torch.no_grad()
    def __call__(self, inputs, key=()):
        return self.fn(inputs)
