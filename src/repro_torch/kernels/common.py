"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at the first
launch in a process, into ``repro_torch/_build/`` (git-ignored); the file
name carries a digest of the sources and flags, so an edited source
rebuilds.  The library is loaded with ``ctypes``: pointers and the stream
go in as ``c_void_p``, and every C entry point returns
``cudaGetLastError()``, which `launch` turns into an exception.

Nothing here runs at import: the host has no ``nvcc``, and the wrappers
only reach `launch` for CUDA tensors.

`kernel_work` is how a wrapper reports its own work to an active
operation count (`repro_torch.launch.op_cost.OpCounter`): the kernel's
``cost(...)`` is added by name, and the ATen operations of whichever route
runs (the twin on the host, the launch's buffers on the card, the meta
route's empty outputs) are hidden from the count, so that a step counts the
same on every device.

`on_local_blocks` is how a DTensor operand (the dry-run's partition, or a
parameter tree placed on a `DeviceMesh`) enters a kernel wrapper: through
`torch.distributed.tensor.experimental.local_map`, each device running the
wrapper on its own blocks.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "launch", "library", "library_path", "refuse_grad", "sm_count", "stream_of",
    "kernel_work", "COST_SINKS", "BUILD_DIR", "is_dtensor", "on_local_blocks",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = (
    "pair_resolve.cu", "event_resolve.cu", "port_stats.cu", "lp_terms.cu",
    "flash_attention.cu", "mlstm_chunk.cu", "quant.cu",
)
# Headers the sources include: they enter the digest, not the compile line.
_HEADERS = ("mma_sync.cuh", "launch.cuh")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature (argument types) of each entry point; all return int.
_SIGNATURES = {
    "pair_resolve": (_P, _P, _P) + (_I,) * 3 + (_P,),
    "pair_resolve_dims": (_I,) * 3 + (_P,),
    "event_resolve": (_P,) * 11 + (_I,) * 4 + (_L, _P),
    "event_resolve_dims": (_I,) * 3 + (_L, _P),
    "port_stats": (_P, _P, _P, _I, _I, _L, _P),
    "port_stats_dims": (_I, _I, _L, _P),
    "lp_terms_batch": (_P,) * 7 + (_I,) * 7 + (_P,),
    "lp_terms": (_P, _P, _P, _F, _F, _P, _P) + (_I,) * 6 + (_P,),
    "lp_terms_smem": (_I,) * 4 + (_P,),
    "flash_attention": (_P,) * 5 + (_I,) * 7 + (_L,) * 12 + (_I, _I, _I, _F) + (_I,) * 4 + (_P,),
    "mlstm_chunk": (_P,) * 11 + (_I,) * 6 + (_P,),
    "mlstm_chunk_smem": (_I, _I, _I, _P, _P),
    "quantize": (_P, _P, _P, _P, _I, _I, _P),
    "dequantize": (_P, _P, _P, _I, _I, _P),
}

_LIB: ctypes.CDLL | None = None

#: Active operation counts, innermost last (`repro_torch.launch.op_cost`
#: pushes and pops them).
COST_SINKS: list = []


@contextlib.contextmanager
def kernel_work(name: str, cost, *args):
    """Around one call of kernel ``name``'s route: with a count active, add
    ``cost(*args)`` (a ``(flops, bytes)`` pair) to the innermost count and
    hide the route's ATen operations from it."""
    if not COST_SINKS:
        yield
        return
    sink = COST_SINKS[-1]
    sink.add_kernel(name, *cost(*args))
    with sink.paused():
        yield


_SM_COUNTS: dict[int, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    """Compile every source in parallel (one ``nvcc -c`` each), then link
    one shared library; the ptxas report lands in ``<target>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in _SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, obj in zip(_SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for name, proc, log in zip(_SOURCES, procs, logs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *_FLAGS, "-shared", *map(str, objs), "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("".join(logs) + link.stdout)
        os.replace(lib_tmp, target)


def library_path() -> Path:
    """Where the library for the current sources lives (its ptxas report
    beside it, with suffix ``.log``)."""
    return BUILD_DIR / f"libkernels-{_digest()}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _LIB
    if _LIB is None:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(device: torch.device) -> int:
    """SMs of CUDA device ``device`` (cached per device: the wrappers' plans
    read it on every call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise where autograd would record an operand of kernel ``name``.

    A kernel writes its result through raw pointers, so that result has no
    autograd graph: a wrapper with no backward calls this before its launch
    rather than hand back a result detached from operands that require
    grad.  (`flash_attention` and `mlstm_chunk` have a backward and route
    such calls through it.)
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an operand requires "
            f"grad; call it under torch.no_grad() or on detached tensors"
        )


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry point ``name`` with ``device`` (the operands' card) the
    current device; raise if the launch was refused.

    The C side launches on the current device and keeps its per-device
    state (the shared-memory limits) under it, while `stream_of` hands it
    the operands' card's stream: on a card other than the current one the
    launch would go astray, so the operands' card is made current first.
    """
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


_DTENSOR: list = []


def is_dtensor(t) -> bool:
    """Whether ``t`` is a `torch.distributed.tensor.DTensor` (a plain
    tensor answers at once: this runs on every kernel call and layer)."""
    if type(t) is torch.Tensor:
        return False
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def on_local_blocks(fn, args: tuple, n_out: int, keep: tuple[int, ...] = (0,)):
    """``fn(*args)`` run on each device's blocks of DTensor operands
    (`torch.distributed.tensor.experimental.local_map`), its ``n_out``
    tensor results DTensors again.

    The blocks: on each mesh axis, the operands' common ``Shard(d)`` with
    ``d`` in ``keep`` (dimensions whose blocks ``fn`` computes apart, such
    as batch and heads) stays; every other placement -- a sharded sequence
    or feature dimension, a pending sum, operands that differ -- becomes
    ``Replicate`` before the call (the collectives that takes are issued),
    so a device that holds all of a replicated dimension repeats that
    work.  Plain tensor operands count as replicated; ``None`` passes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = tuple(
        DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
        for a in args)
    tensors = [a for a in args if isinstance(a, DTensor)]
    chosen = []
    for i in range(mesh.ndim):
        ps = {a.placements[i] for a in tensors}
        p = ps.pop() if len(ps) == 1 else Replicate()
        chosen.append(p if isinstance(p, Shard) and p.dim in keep else Replicate())
    chosen = tuple(chosen)
    in_pl = tuple(chosen if isinstance(a, DTensor) else None for a in args)
    out_pl = (chosen,) * n_out
    return local_map(fn, out_placements=out_pl, in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
