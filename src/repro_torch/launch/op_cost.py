"""ATen operation counts of a step: the port's counterpart of the
reference's HLO cost analyzer (`repro.launch.hlo_cost`).

PyTorch lowers no HLO, so the reference's input does not exist here.
`OpCounter` is a `TorchDispatchMode`: inside it every ATen operation the
step issues (the backward's included, on any device, ``meta`` too) is
counted as it runs:

  * operations -- products (``mm``, ``bmm``, ``addmm``, convolutions, ...)
    from PyTorch's own registry (`torch.utils.flop_counter`), exact;
    elementwise operations and reductions by the reference's weights per
    element (``hlo_cost.py:51-64``: 1 for arithmetic and compares, 2 for
    clamp, 4 for ``sqrt`` / ``rsqrt``, 8 for the other transcendentals, 10
    for ``pow`` and ``atan2``; a fused ATen op such as ``silu`` or
    ``_softmax`` the sum of its parts); copies, gathers, scatters and sorts
    none;
  * bytes -- each operation's tensor inputs and outputs, views none.
    Nothing is fused, so this counts more than the reference's top-level
    fused HLO instructions do;
  * the high-water mark of live bytes the step made (the storages its
    operations returned, alive until freed), which stands in for XLA's
    ``memory_analysis()`` temporaries;
  * kernels -- the port's hand-written kernels are invisible to a dispatch
    mode (they launch through ``ctypes``): each wrapper adds its own
    ``cost(...)`` by name and hides the ATen operations of its route
    (`repro_torch.kernels.common.kernel_work`), so a step counts the same
    on ``meta``, on the host and on the card.

  * time loops -- a model's loop over positions (the sLSTM's) asks
    `time_loop` how many steps to run: on ``meta`` under an active count
    it runs one, counted by the trip count, as the reference's analyzer
    multiplies a scan body; every step issues the same operations at the
    same shapes, and what outlives a step goes to buffers made before the
    loop, so the operations, bytes and high-water mark equal those of
    every step run (``tests/test_torch_launch.py``);

  * collectives -- on DTensors (the dry-run's partition over a fake
    process group, `repro_torch.launch.dryrun`) the counter sees what one
    device runs: DTensor's own shape propagation (global shapes, under
    its `FakeTensorMode`) is neither counted nor tracked, a DTensor
    operation is left to DTensor (the counter returns ``NotImplemented``)
    and counted in the local operations DTensor issues, at local shapes,
    and each ``_c10d_functional`` collective (and DTensor's
    ``shard_dim_alltoall``) adds its local output's bytes
    to `OpCost.collective_bytes` under the reference's kind names
    (``hlo_cost.py``: all-reduce counted twice) and to the bytes.  The
    high-water mark tracks the local tensors' storages (a DTensor is a
    wrapper with none of its own).

    with OpCounter() as counter:
        step(...)
    cost = counter.cost          # OpCost: flops, bytes, peak_bytes, ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import common

__all__ = ["OpCost", "OpCounter", "COLLECTIVE_OPS", "time_loop"]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# Operations per output element (the reference's weights), and how many of
# them are transcendentals.
_ELEMENTWISE = {
    **dict.fromkeys(
        ("add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne", "lt", "le",
         "gt", "ge", "where", "logical_and", "logical_or", "logical_xor", "logical_not",
         "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "neg", "abs", "floor",
         "ceil", "round", "sign", "clamp_min", "clamp_max", "masked_fill", "reciprocal",
         "square", "lerp", "addcmul", "addcdiv"), (1, 0)),
    "clamp": (2, 0),
    "sqrt": (4, 1), "rsqrt": (4, 1),
    **dict.fromkeys(("exp", "log", "tanh", "sigmoid", "sin", "cos", "erf", "expm1",
                     "log1p"), (8, 1)),
    "pow": (10, 1), "atan2": (10, 1),
    # Fused ATen operations: the sum of their parts.
    "silu": (9, 1),  # logistic, multiply
    "gelu": (16, 1),  # the tanh form: cube, 5 multiply-adds, tanh
    "softplus": (19, 2),  # exp, log1p, compare, select, multiply
    "log_sigmoid_forward": (19, 2),
    "silu_backward": (12, 1),
    "gelu_backward": (24, 1),
    "sigmoid_backward": (2, 0), "tanh_backward": (2, 0),
    "log_sigmoid_backward": (12, 1),
    "softplus_backward": (12, 1),
    "threshold_backward": (1, 0),
}
# Operations per input element: reductions, and fused softmax-like rows.
_PER_INPUT = {
    **dict.fromkeys(("sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
                     "argmax", "argmin", "cumsum", "cumprod", "index_add", "scatter_add",
                     "index_put"), (1, 0)),
    "_softmax": (12, 1),  # max, subtract, exp, sum, divide
    "_log_softmax": (12, 1),
    "logsumexp": (11, 1),  # max, subtract, exp, sum
    "_softmax_backward_data": (3, 0),
    "_log_softmax_backward_data": (11, 1),
}
# Operations that move no bytes besides views: allocation, aliasing.
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "_unsafe_view", "set_", "resize_", "_local_scalar_dense", "wait_tensor",
            "_wrap_tensor_autograd"}
# The functional collectives DTensor issues, by the reference's kind names
# (`repro.launch.hlo_cost`), and how many times their output's bytes count.
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "all_gather_into_tensor_out": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 1),
    "shard_dim_alltoall": ("all-to-all", 1),  # DTensor's own (namespace _dtensor)
}


@dataclasses.dataclass
class OpCost:
    """What a step did: operations (``flops``, of which ``matmul_flops``
    products and ``transcendentals`` counted apart), bytes, the ATen
    operations issued, the high-water mark of live bytes it made
    (``peak_bytes``), per-ATen-op and per-kernel breakdowns, and collective
    bytes by kind (zero on one card and for plain tensors)."""

    flops: float = 0.0
    bytes: float = 0.0
    matmul_flops: float = 0.0
    transcendentals: float = 0.0
    ops: int = 0
    peak_bytes: int = 0
    by_op: dict[str, list[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))
    kernels: dict[str, list[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_OPS, 0.0))

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    def summary(self) -> dict:
        """The totals and the kernels' shares as plain numbers (JSON)."""
        return {
            "flops": self.flops, "bytes": self.bytes, "matmul_flops": self.matmul_flops,
            "transcendentals": self.transcendentals, "ops": self.ops,
            "peak_bytes": self.peak_bytes,
            "kernels": {k: {"calls": c, "flops": f, "bytes": b}
                        for k, (c, f, b) in sorted(self.kernels.items())},
        }


def _propagating() -> bool:
    """Whether DTensor's shape propagation is running: it runs each
    operation at global shapes under a `FakeTensorMode`, work that no
    device does."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in an operation's arguments or results (nested tuples,
    lists and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def time_loop(steps: int, x: torch.Tensor):
    """Around a loop of ``steps`` steps of the same shapes over ``x``:
    yields how many to run.  Under an active count on ``meta`` (a DTensor's
    local blocks included) one, counted ``steps`` times (`OpCounter.
    repeat`); elsewhere all of them."""
    local = x.to_local() if isinstance(x, DTensor) else x
    if steps <= 1 or not common.COST_SINKS or local.device.type != "meta":
        yield steps
        return
    with common.COST_SINKS[-1].repeat(steps):
        yield 1


class OpCounter(TorchDispatchMode):
    """A dispatch mode counting every ATen operation issued inside it into
    `cost` (module doc).  Kernel wrappers add their own costs through
    `add_kernel` and hide their routes' operations under `paused`; a time
    loop on ``meta`` runs one step counted by its trip count
    (`time_loop`)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._paused = 0
        self._times = 1
        self._live: set[int] = set()
        self._live_bytes = 0

    def __enter__(self):
        common.COST_SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        common.COST_SINKS.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        n = self._times
        entry = self.cost.kernels[name]
        entry[0] += n
        entry[1] += n * flops
        entry[2] += n * nbytes
        self.cost.flops += n * flops
        self.cost.bytes += n * nbytes

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Work issued inside counts ``n`` times: a loop body run once that
        stands for ``n`` runs of the same shapes.  The high-water mark is
        the one run's."""
        self._times *= n
        try:
            yield
        finally:
            self._times //= n

    @contextlib.contextmanager
    def paused(self):
        """Operations issued inside are not counted (their storages still
        enter the high-water mark)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _track(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            storage = t.untyped_storage()
            key = id(storage)
            if key in self._live:
                continue
            size = storage.nbytes()
            self._live.add(key)
            self._live_bytes += size
            weakref.finalize(storage, self._free, key, size)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)

    def _free(self, key: int, size: int) -> None:
        self._live.discard(key)
        self._live_bytes -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _propagating():
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if not func.is_view:
            held = {id(t.untyped_storage()) for t in ins}
            self._track([t for t in outs if id(t.untyped_storage()) not in held])
        if not self._paused:
            self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        cost = self.cost
        name = func._overloadpacket.__name__
        n = self._times
        if func.namespace in ("_c10d_functional", "_dtensor") and name in _COLLECTIVES:
            kind, times = _COLLECTIVES[name]
            nbytes = float(sum(_nbytes(t) for t in outs))
            cost.collective_bytes[kind] += n * times * nbytes
            cost.bytes += n * nbytes
            cost.ops += n
            entry = cost.by_op[name]
            entry[0] += n
            entry[2] += n * nbytes
            return
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        flops = transcendentals = 0.0
        if func._overloadpacket in flop_registry:
            flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
        elif base in _ELEMENTWISE:
            w, tr = _ELEMENTWISE[base]
            elems = sum(t.numel() for t in outs[:1])
            flops, transcendentals = float(w * elems), float(tr * elems)
        elif base in _PER_INPUT:
            w, tr = _PER_INPUT[base]
            elems = max((t.numel() for t in ins), default=0)
            flops, transcendentals = float(w * elems), float(tr * elems)
        nbytes = 0.0
        if not func.is_view and base not in _NO_DATA:
            nbytes = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        if func._overloadpacket in flop_registry:
            cost.matmul_flops += n * flops
        cost.ops += n
        cost.flops += n * flops
        cost.bytes += n * nbytes
        cost.transcendentals += n * transcendentals
        entry = cost.by_op[name]
        entry[0] += n
        entry[1] += n * flops
        entry[2] += n * nbytes
