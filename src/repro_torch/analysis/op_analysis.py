"""Cost and collective accounting of one eager step (the port's counterpart
of ``repro.analysis.hlo_analysis``).

The JAX package lowers a step to HLO and parses the compiled text.  The port
has no compiled program: its step is the sequence of aten operations that
eager PyTorch runs.  :class:`OpCounter`, a ``TorchDispatchMode``, sees each
of them, forward and backward, and counts:

* **flops**: 2 * |out| * |contracting| for every matmul-family op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``), the dot rule of
  ``analyze_hlo``, plus the flops each hand kernel charges at its call;
* **bytes**: the inputs plus the outputs of every op that is neither a view
  nor a metadata op (``empty``, ``detach``, shape queries).  Eager PyTorch
  fuses nothing, so this is what the card moves.  A gather (``index``,
  ``embedding``, ``index_select``) is charged twice its output, as XLA's
  ``gather`` is; a copy into a slice (``copy_``) its source and destination.
  A hand kernel is charged its own count (each input read once, the output
  written once) and the tensor operations of its wrapper are not counted;
* **collectives**: every ``psum``, ``pmax``, ``all_gather``,
  ``psum_scatter`` and ``all_to_all`` of
  :class:`~repro_torch.models.transformer.RunCtx` reports its kind, its
  group size and its operand bytes a position, defined from the output as
  ``hlo_analysis._collective_from_line`` defines them (all-reduce: the
  output; all-gather: output / g; reduce-scatter: output * g; all-to-all:
  the output).  ``pmax`` is an all-reduce.  Under autograd each of them
  also reports its backward's collective when the gradient reaches it (a
  psum's is an all-reduce, an all-gather's a reduce-scatter and back, an
  all-to-all's an all-to-all; a pmax has none).  A group of one is no
  collective.  :class:`CollectiveOp` keeps JAX's ring ``wire_bytes``.
  (A backward collective is hooked onto the group of position 0, whose
  values the meshed loss reads, and counted for every position.)

A meshed model runs every position in one process, so the totals cover the
whole mesh: per device is the total over ``num_partitions``.  Argument
bytes a position are exact when the caller gives them (the dry run reads
them from a position's shards).  ``memory`` has ``_memory_dict``'s keys:
``total_hbm_bytes`` is the peak of the live storage bytes the mode tracks
(the arguments, and every storage an op allocates, until it is freed),
``alias_size_in_bytes`` the argument bytes freed during the step (a donated
state), and ``temp_size_in_bytes`` what the peak holds beyond the
arguments and the outputs, so that ``total = argument + output + temp -
alias`` as in the JAX records.  On ``meta`` tensors the peak covers every
position at once, as one card's allocator does for a mesh of ``cuda:0``
positions.

The counter also keeps each phase's totals and peak (a phase is a run of
forward ops or of backward ops: a train step's forward, backward and
update, once a microbatch), which the dry run's trip-aware count extends
phase by phase.  On ``meta`` tensors it runs each op's Python meta
implementation once a signature (the op, its tensors' dtypes, shapes,
strides and offsets, its other arguments) and makes a later call's output
afresh from the first's shapes: a meshed step repeats every op once a
position.  An op whose output is not a fresh tensor runs every time.

The port counts every tensor at its true dtype, so the JAX package's
``bf16_model`` width correction (the CPU backend's float normalisation) and
its ``cost_raw_f32`` record have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import weakref
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
# dot-family ops: (index of the left operand, its contracting dim)
_DOTS = {
    _aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0, _aten.dot.default: 0,
    _aten.addmm.default: 1, _aten.baddbmm.default: 1, _aten.addmv.default: 1,
}
# ops that move no bytes of their own
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default, _aten.set_.source_Storage,
    _aten.resize_.default, _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default,
    _aten.sym_storage_offset.default, _aten.is_same_size.default,
}
# sliced reads: the gathered rows, not the whole table (XLA's ``gather``)
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.embedding.default,
            _aten.gather.default}
_WRITE_ONLY = {_aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}

# Frames of the model code an op is attributed to (op_top).
_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "models") + os.sep


@dataclasses.dataclass
class CollectiveOp:
    """One collective as ``hlo_analysis.CollectiveOp``: operand bytes a
    position, its group size and the ring algorithm's wire bytes."""

    kind: str
    operand_bytes: float
    group_size: int

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        if self.kind == "all-reduce":
            f = 2 * (g - 1) / g
        else:  # all-gather / reduce-scatter / all-to-all per-operand ring
            f = (g - 1) / g
        return self.operand_bytes * f


_ACTIVE: list = []  # the counters open now, innermost last
_STATE = threading.local()  # .quiet: depth of kernel wrappers being run


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    ``TrainState``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


# RunCtx's own frames: a collective is attributed to the code calling it
_COLLECTIVE_FRAMES = {"_groupwise", "psum", "pmax", "all_gather", "psum_scatter", "all_to_all",
                      "gather", "a2a"}


def where() -> str:
    """The innermost frame of the model code calling, as ``file:line
    (function)``; in a backward pass without one, the autograd node."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_MODELS_DIR) and f.f_code.co_name not in _COLLECTIVE_FRAMES:
            return f"models/{fn[len(_MODELS_DIR):]}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward {node.name()}"
    return "(outside the models)"


@contextmanager
def kernel_region():
    """A hand kernel's wrapper runs inside: its own tensor operations are
    the kernel's, charged by :func:`charge_kernel`, not counted as ops."""
    _STATE.quiet = getattr(_STATE, "quiet", 0) + 1
    try:
        yield
    finally:
        _STATE.quiet -= 1


def _quiet() -> bool:
    return getattr(_STATE, "quiet", 0) > 0


def charge_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand kernel's launch (or its ``meta`` stand-in) -> the counter open."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, flops, nbytes)


def charge_collective(kind: str, group_size: int, operand_bytes: float, members: int,
                      positions: int) -> None:
    """``members`` positions of a ``group_size`` group of a mesh of
    ``positions`` each ran a collective of ``kind`` on ``operand_bytes``."""
    if _ACTIVE and group_size > 1:
        _ACTIVE[-1].add_collective(kind, group_size, operand_bytes, members, positions)


def collective_operand_bytes(kind: str, out_bytes: int, g: int) -> float:
    """Operand bytes from the output, as ``_collective_from_line``."""
    if kind == "all-gather":
        return out_bytes / max(g, 1)
    if kind == "reduce-scatter":
        return float(out_bytes * max(g, 1))
    return float(out_bytes)


# the collective a collective's backward runs
BACKWARD_KIND = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
                 "reduce-scatter": "all-gather", "all-to-all": "all-to-all"}


def report_collective(kind: str, outs: list, g: int, positions: int, *, shared: bool,
                      first: bool, backward: bool = True) -> None:
    """A collective of one group ran: ``outs`` its results (one tensor the
    group shares when ``shared``, else one a member).  Reports it and, for
    the ``first`` group of the call (the one holding position 0, whose
    values every meshed loss reads), where its result takes part in
    autograd, hooks the backward's collective onto it, counted for every
    position: in the backward every position receives its gradient
    (``backward`` False: none, as for a pmax)."""
    if not _ACTIVE or g <= 1:
        return
    each = outs[:1] if shared else outs
    members = g if shared else 1
    for r in each:
        charge_collective(kind, g, collective_operand_bytes(kind, _nbytes(r), g), members,
                          positions)
    r = outs[0]
    if first and backward and torch.is_grad_enabled() and r.requires_grad:
        # the backward's operand is this result's gradient: the same bytes
        # for every kind (a psum's and an all-to-all's output, an
        # all-gather's whole, a reduce-scatter's chunk)
        def hook(grad, back=BACKWARD_KIND[kind], op_bytes=float(_nbytes(r))):
            charge_collective(back, g, op_bytes, positions, positions)

        r.register_hook(hook)


def _classify(func) -> str:
    """How the mode counts ``func`` (cached a function)."""
    if torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
        return "composite"
    if func.namespace == "repro_torch":
        return "custom"
    if func in _FREE:
        return "free"
    returns = func._schema.returns
    if any(r.alias_info is not None and not r.alias_info.is_write for r in returns):
        return "view"
    if func in _GATHERS:
        return "gather"
    if func is _aten.copy_.default:
        return "copy"
    if func in _WRITE_ONLY:
        return "write"
    if func in _DOTS:
        return "dot"
    if any(r.alias_info is not None and r.alias_info.is_write for r in returns):
        return "inplace"
    return "plain"


_KINDS: dict = {}


def _flat(args, kwargs) -> list:
    """The tensors among an op's arguments (directly or in a list)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.memory_format,
            torch.layout)


class _Uncached(Exception):
    pass


def _signature(a):
    """What a ``meta`` op's output can depend on: a tensor's shape, strides,
    offset and dtype, any other argument's type and value."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise _Uncached
        return (a.dtype, a.shape, a.stride(), a.storage_offset())
    if isinstance(a, (list, tuple)):
        return tuple([_signature(x) for x in a])
    if isinstance(a, _SCALARS) and a == a:  # a NaN matches no key
        return (type(a), a)
    raise _Uncached


def _fresh(spec):
    """A new ``meta`` tensor (or a tuple or list of them) of ``spec``."""
    if spec is None:
        return None
    if spec[0] in ("tuple", "list"):
        items = [_fresh(x) for x in spec[1]]
        return tuple(items) if spec[0] == "tuple" else items
    dtype, shape, stride = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _spec(out, seen: set):
    """``out``'s spec for :func:`_fresh`, if a fresh tensor of it is
    ``out``'s equal (its own storage, none in ``seen``, of the same bytes);
    else raises."""
    if out is None:
        return None
    if isinstance(out, (tuple, list)):
        return ("tuple" if isinstance(out, tuple) else "list", [_spec(x, seen) for x in out])
    if not isinstance(out, torch.Tensor) or not out.is_meta or out.storage_offset():
        raise _Uncached
    st = out.untyped_storage()
    if id(st) in seen:
        raise _Uncached
    seen.add(id(st))
    spec = (out.dtype, tuple(out.shape), out.stride())
    if _fresh(spec).untyped_storage().nbytes() != st.nbytes():
        raise _Uncached
    return spec


_MEMO_KINDS = frozenset(("plain", "dot", "gather"))
_MISSING = object()


def _run_meta(func, args, kwargs, memo: dict):
    """``func(*args, **kwargs)`` on ``meta`` tensors, its output made from
    the spec ``memo`` keeps of an earlier call with the same signature
    (None: none to keep): a meshed step runs each op once a position, on
    the same shapes, and the Python meta implementations are most of a
    count's time.  An op whose output is not a fresh tensor (or tuple of
    them) is run every time."""
    try:
        key = (func, _signature(args), _signature(tuple(kwargs.items())) if kwargs else ())
    except _Uncached:
        return func(*args, **kwargs)
    spec = memo.get(key, _MISSING)
    if spec is not _MISSING and spec is not None:
        return _fresh(spec)
    out = func(*args, **kwargs)
    if spec is _MISSING:
        try:  # an output that is an input's storage is no fresh tensor
            memo[key] = _spec(out, {id(t.untyped_storage()) for t in _flat(args, kwargs)})
        except _Uncached:
            memo[key] = None
    return out


class OpCounter(TorchDispatchMode):
    """Counts the flops, bytes, collectives, kernel charges and live
    storage bytes of everything run inside it (see the module docstring).
    ``keep_ops`` keeps one record an op for :mod:`repro_torch.analysis.op_top`:
    ``(bytes, flops, collective operand bytes, kind, where)``."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.keep_ops = keep_ops
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}
        self.coll: dict = {}  # kind -> [member-ops, operand bytes summed, wire bytes summed]
        self.sites: set = set()
        self.ops: list = []
        self.live = 0
        self.peak = 0
        # the peak of each phase (a run of forward ops, or of backward
        # ops), and the totals where each began
        self.phase_peaks = [0]
        self._phase_starts = []
        self._backward = False
        self._meta_outs: dict = {}  # _run_meta's specs
        self._tracked: dict = {}  # id(storage) -> (nbytes, weak reference)
        self._args: set = set()
        self.args_freed = 0

    # -- live storage -------------------------------------------------------
    def _track(self, st, is_arg: bool = False) -> None:
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = (n, weakref.ref(st, lambda _, key=key: self._freed(key)))
        if is_arg:
            self._args.add(key)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        if self.live > self.phase_peaks[-1]:
            self.phase_peaks[-1] = self.live

    def _freed(self, key) -> None:
        n = self._tracked.pop(key, (0, None))[0]
        self.live -= n
        if key in self._args:
            self._args.discard(key)
            self.args_freed += n

    def track_arguments(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as live arguments ->
        their distinct bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t.untyped_storage(), is_arg=True)
        return self.live - before

    # -- charges ------------------------------------------------------------
    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        if self.keep_ops:
            self.ops.append((float(nbytes), float(flops), 0.0, f"kernel {name}", where()))

    def add_collective(self, kind, g, operand_bytes, members, positions) -> None:
        op = CollectiveOp(kind, operand_bytes, g)
        slot = self.coll.setdefault(kind, [0, 0.0, 0.0])
        slot[0] += members / positions
        slot[1] += operand_bytes * members / positions
        slot[2] += op.wire_bytes * members / positions
        site = where()
        self.sites.add((kind, g, site))
        if self.keep_ops:
            self.ops.append((0.0, 0.0, operand_bytes * members / positions,
                             f"{kind}(g={g})", site))

    # -- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        backward = torch._C._current_autograd_node() is not None
        if backward != self._backward:
            self._backward = backward
            self.phase_peaks.append(self.live)
            self._phase_starts.append(self._totals())
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _classify(func)
        if kind == "composite" and not _quiet():
            # Under inference mode a composite op (matmul, einsum, linear)
            # reaches the mode whole: count the ops it decomposes into, as
            # autograd's dispatch does with grad on.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if kind in _MEMO_KINDS:
            out = _run_meta(func, args, kwargs, self._meta_outs)
        else:
            out = func(*args, **kwargs)
        if kind in ("free", "view") or _quiet():
            return out
        ins = _flat(args, kwargs)
        if kind == "custom" and not any(t.is_cpu for t in ins):
            # the selection kernels' custom operators: charged by the kernel
            # itself on meta and CUDA tensors, counted as one op on the CPU
            return out
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,), {})
        flops = 0.0
        if kind == "gather":
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        elif kind == "copy":
            nbytes = _nbytes(args[0]) + _nbytes(args[1])
        elif kind == "write":
            nbytes = _nbytes(args[0])
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            if kind == "dot":
                flops = 2.0 * sum(t.numel() for t in outs) * args[_DOTS[func]].shape[-1]
        self.flops += flops
        self.bytes += nbytes
        if kind not in ("inplace", "copy", "write"):
            for t in outs:
                self._track(t.untyped_storage())
        if self.keep_ops:
            self.ops.append((float(nbytes), flops, 0.0, str(func.overloadpacket.__name__),
                             where()))
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- the record ---------------------------------------------------------
    def _totals(self) -> tuple:
        return (self.flops, self.bytes, {k: list(v) for k, v in self.coll.items()},
                {k: dict(v) for k, v in self.kernels.items()})

    def phases(self, n: int) -> list:
        """Each phase's flops, bytes, collectives (``by_type``) and kernel
        charges, per device of ``n``."""
        marks = [(0.0, 0.0, {}, {})] + self._phase_starts + [self._totals()]
        out = []
        for (f0, b0, c0, k0), (f1, b1, c1, k1) in zip(marks, marks[1:]):
            coll = {}
            for kind, v in c1.items():
                u = c0.get(kind, [0, 0.0, 0.0])
                if v != u:
                    coll[kind] = {"operand_bytes": v[1] - u[1], "wire_bytes": v[2] - u[2],
                                  "count": round(v[0]) - round(u[0])}
            kern = {}
            for name, v in k1.items():
                u = k0.get(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
                if v != u:
                    kern[name] = {"calls": v["calls"] - u["calls"],
                                  "flops": (v["flops"] - u["flops"]) / n,
                                  "bytes": (v["bytes"] - u["bytes"]) / n}
            out.append({"flops": (f1 - f0) / n, "bytes": (b1 - b0) / n,
                        "collectives": {"by_type": coll}, "kernels": kern})
        return out

    def collectives(self) -> dict:
        """The collective block of ``analyze_hlo``, per device."""
        by_type = {k: {"operand_bytes": v[1], "wire_bytes": v[2], "count": round(v[0])}
                   for k, v in self.coll.items()}
        return {"operand_bytes": sum(v["operand_bytes"] for v in by_type.values()),
                "wire_bytes": sum(v["wire_bytes"] for v in by_type.values()),
                "by_type": by_type, "num_static_sites": len(self.sites)}


def analyze_step(fn, *args, num_partitions: int = 1, argument_bytes: float | None = None,
                 keep_ops: bool = False) -> dict:
    """Run ``fn(*args)`` under an :class:`OpCounter` -> per-device
    ``{flops, bytes, num_partitions, collectives, memory, kernels}`` (the
    keys of ``analyze_hlo`` plus ``memory`` as the dry run's
    ``_memory_dict`` and the kernels' charges), ``phase_peaks`` (the peak
    live bytes of each run of forward ops and of backward ops, in order:
    ``total_hbm_bytes`` is their maximum) and ``phases`` (each run's
    flops, bytes, collectives and kernel charges), ``ops`` with
    ``keep_ops``.
    ``argument_bytes`` (a position's) defaults to the arguments' distinct
    storage bytes over ``num_partitions``."""
    n = num_partitions
    counter = OpCounter(keep_ops=keep_ops)
    with counter:
        arg_total = counter.track_arguments(args)
        result = fn(*args)
    out_st = {}
    for t in _tensors(result):
        st = t.untyped_storage()
        if id(st) not in counter._args:
            out_st[id(st)] = st.nbytes()
    out_bytes = int(sum(out_st.values()) / n)
    arg = int(arg_total / n if argument_bytes is None else argument_bytes)
    total = int(counter.peak / n)
    alias = int(counter.args_freed / n)
    memory = {"argument_size_in_bytes": arg, "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": max(total - arg - out_bytes + alias, 0),
              "alias_size_in_bytes": alias, "total_hbm_bytes": total}
    rec = {"flops": counter.flops / n, "bytes": counter.bytes / n, "num_partitions": n,
           "collectives": counter.collectives(), "memory": memory,
           "phase_peaks": [int(p / n) for p in counter.phase_peaks],
           "phases": counter.phases(n),
           "kernels": {k: {**v, "flops": v["flops"] / n, "bytes": v["bytes"] / n}
                       for k, v in counter.kernels.items()}}
    if keep_ops:
        rec["ops"] = [(b / n, f / n, c, kind, at) for b, f, c, kind, at in counter.ops]
    return rec


def collective_stats(fn, *args, num_partitions: int = 1) -> dict:
    """Just the collective block of :func:`analyze_step`."""
    return analyze_step(fn, *args, num_partitions=num_partitions)["collectives"]


__all__ = ["CollectiveOp", "OpCounter", "analyze_step", "charge_collective",
           "charge_kernel", "collective_stats", "kernel_region", "report_collective", "where"]
