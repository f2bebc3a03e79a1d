"""Dry-run of every (arch x shape x mesh) cell on the ``meta`` device (port
of `repro.launch.dryrun`).

For each cell this builds the mesh (the card's local one, or the
reference's production meshes, 16x16 single-pod and 2x16x16 multi-pod, as
descriptions with no cards), the sharding-annotated meta inputs
(`repro_torch.launch.specs`, zero allocation), and runs the step (train,
prefill or serve) on ``meta`` under the ATen operation counter
(`repro_torch.launch.op_cost`), recording:

  * per-device argument bytes, exact, from the specs' shard shapes;
  * the step's operations and bytes accessed, its kernels' shares, and the
    high-water mark of the bytes it made (temporaries, outputs included);
  * the three roofline terms and the dominant one (`launch.roofline`).

A time loop (the sLSTM's) runs one step counted by its trip count, as
the reference's analyzer multiplies a scan body (`op_cost.time_loop`; the
count equals that of every step run).

On a mesh of more than one chip the step is partitioned as the
reference's GSPMD partitions it (``"partition": "spmd"``): a fake process
group of the mesh's size comes up for the cell (PyTorch's ``"fake"``
backend, which moves no data; torn down after the cell, also when it
fails), parameters, optimizer state, batch and cache become ``meta``
DTensors placed by their partition specs (`specs.dtensors`), the models'
`sharding.constrain` hints redistribute at the reference's sites, and the
counter sees what one device runs: operations, bytes and temporaries at
local shapes, and the collectives DTensor issues, by kind, into the
roofline's collective term.  On one chip nothing is partitioned
(``"whole"``).  A cell refuses to run while a real process group is up.
A failure (a spec that does not divide, a kernel's check, a shape the
model refuses, an operation DTensor cannot partition) is a bug: the run
fails loudly.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import tree
from repro_torch.configs import SHAPES, ShapeSpec, get_arch
from repro_torch.launch.mesh import Mesh, device_mesh, make_local_mesh, make_production_mesh
from repro_torch.launch.op_cost import COLLECTIVE_OPS, OpCounter
from repro_torch.launch.roofline import HW, model_flops, roofline_terms
from repro_torch.launch.sharding import ShardingRules, activate
from repro_torch.launch.specs import (
    auto_mode, batch_specs, cache_specs, decode_batch_specs, device_bytes, dtensors,
    opt_specs, param_specs, spec_leaves, values,
)
from repro_torch.launch.steps import (
    accumulate_microbatch, default_optimizer, loss_and_grad, make_prefill_step,
    make_serve_step, zero_accumulators,
)
from repro_torch.models.model import build_model

__all__ = ["run_cell", "mesh_name", "main", "partitioned"]

MESHES = ("local", "single", "multi")


def mesh_name(mesh: Mesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` (the reference's names) for the
    production meshes, ``local{data}x{model}`` for a local one."""
    if not mesh.devices:
        return "pod" + "x".join(map(str, mesh.shape))
    return "local" + "x".join(map(str, mesh.shape))


def _make_mesh(mesh: str, device: str) -> Mesh:
    if mesh == "local":
        return make_local_mesh(device)
    if mesh in ("single", "multi"):
        return make_production_mesh(multi_pod=mesh == "multi")
    raise ValueError(f"mesh {mesh!r} not in {MESHES}")


@contextlib.contextmanager
def partitioned(mesh: Mesh):
    """A fake process group of ``mesh.size`` ranks (this process rank 0)
    and the `DeviceMesh` over it, for one cell; torn down on the way out,
    also on failure.  Refuses while any process group is up: a fake
    default group left behind would make every rank count of the process
    (`mesh.process_shard`) read the mesh's size."""
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("dry-run partition: this PyTorch has no torch.distributed")
    if dist.is_initialized():
        raise RuntimeError("dry-run partition: a process group is already up")
    try:
        # Importing the module registers the "fake" backend.
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("dry-run partition: this PyTorch has no fake process group") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield device_mesh(Mesh(mesh.axis_names, mesh.shape))
    finally:
        dist.destroy_process_group()


def _micro(x, n: int):
    """The first of ``n`` microbatches of ``x``'s rows: on a DTensor each
    device's first ``1 / n`` of its own rows (the reference's microbatch
    reshape of a data-sharded batch stays local), a DTensor again."""
    from repro_torch.kernels.common import is_dtensor

    if not is_dtensor(x):
        return x[: len(x) // n]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    shape = (len(x) // n, *x.shape[1:])
    return DTensor.from_local(local[: len(local) // n], x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _train_step(model, optimizer, n: int, counter: OpCounter):
    """`steps.make_train_step`'s step as the dry-run counts it: every
    microbatch has the same shapes, so one runs under ``counter.repeat(n)``
    (the reference's analyzer multiplies a scan body by its trip count)."""

    def step(params, opt_state, batch):
        if n == 1:
            loss, grads = loss_and_grad(model, params, batch)
        else:
            loss, grads = zero_accumulators(model, params)
            micro = {k: _micro(v, n) for k, v in batch.items()}
            with counter.repeat(n):
                loss = accumulate_microbatch(model, params, micro, loss, grads, n)
        params, opt_state, stats = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return step


def _local_bytes(t: torch.Tensor) -> int:
    """Bytes one device holds of ``t`` (a DTensor's local block)."""
    from repro_torch.kernels.common import is_dtensor

    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def run_cell(
    arch: str,
    shape_name: str | ShapeSpec,
    mesh: str = "single",
    zero1: bool = False,
    num_microbatches: int = 0,  # 0 = auto
    cfg_overrides: dict | None = None,
    mixed_precision: bool = False,  # bf16 params + f32 master (train)
    rules_overrides: dict | None = None,
    device: str = "cuda",  # the local mesh's cards ("cpu": the host's (1, 1))
    hbm_bytes: float = HW.hbm_bytes,
) -> dict:
    """One cell's dry-run (module doc).  ``shape_name`` names one of
    `SHAPES` or is a `ShapeSpec`; ``cfg_overrides`` replace config fields.
    The result has the reference's keys where they have a meaning:
    ``trace_s`` (host seconds of the meta run) for ``compile_s``;
    ``memory.fits_hbm`` beside ``memory.hbm_bytes`` for ``fits_hbm_16g``;
    the counter's figures under ``cost`` (no XLA figures); ``partition``."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    the_mesh = _make_mesh(mesh, device)
    chips = the_mesh.size
    rules = ShardingRules(the_mesh, overrides=rules_overrides)
    data_ways = rules.sizes.get("data", 1) * rules.sizes.get("pod", 1)
    if cfg.num_experts:
        # Align dispatch groups with the data-parallel shards.
        cfg = dataclasses.replace(cfg, moe_groups=data_ways)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = build_model(cfg, "meta")
    t0 = time.perf_counter()

    mode = auto_mode(model, rules, "train" if shape.kind == "train" else "serve", hbm_bytes)
    if num_microbatches == 0:
        # Auto: bound live tokens a device (MoE dispatch buffers scale with
        # live tokens x top_k; dense trains gain activation headroom too).
        if shape.kind == "train":
            target = 8192 if cfg.num_experts else 16384
            tokens_per_dev = shape.global_batch * shape.seq_len // data_ways
            num_microbatches = max(1, tokens_per_dev // target)
            num_microbatches = min(num_microbatches, max(shape.global_batch // data_ways, 1))
        else:
            num_microbatches = 1
    counter = OpCounter()
    spmd = chips > 1
    with contextlib.ExitStack() as stack:
        dmesh = stack.enter_context(partitioned(the_mesh)) if spmd else None
        stack.enter_context(activate(rules, dmesh))
        if spmd:
            from torch.distributed.tensor.experimental import implicit_replication

            stack.enter_context(implicit_replication())
        place = (lambda t: dtensors(t, dmesh)) if spmd else values
        if shape.kind == "train":
            opt = default_optimizer()
            if mixed_precision:
                opt = dataclasses.replace(opt, master_weights=True)
            p = param_specs(model, rules, mode=mode,
                            dtype=torch.bfloat16 if mixed_precision else None)
            o = opt_specs(model, rules, opt, zero1=zero1, mode=mode)
            b = batch_specs(cfg, shape, rules, with_labels=True)
            args, inputs = (p, o, b), (place(p), place(o), place(b))
            step = _train_step(model, opt, num_microbatches, counter)
            with counter:
                out = step(inputs[0], {**inputs[1], "count": 0}, inputs[2])
        elif shape.kind == "prefill":
            p = param_specs(model, rules, mode=mode, dtype=torch.bfloat16)
            b = batch_specs(cfg, shape, rules, with_labels=False)
            args, inputs = (p, b), (place(p), place(b))
            with counter:
                out = make_prefill_step(model)(*inputs)
        else:  # decode: one new token at the last position of a full cache
            p = param_specs(model, rules, mode=mode, dtype=torch.bfloat16)
            cache = cache_specs(model, rules, shape.global_batch, shape.seq_len)
            b = decode_batch_specs(cfg, shape, rules)
            args, inputs = (p, cache, b), (place(p), place(cache), place(b))
            with counter:
                out = make_serve_step(model)(*inputs, shape.seq_len - 1)
        trace_s = time.perf_counter() - t0

        cost = counter.cost
        held = {id(t): s for a, v in zip(args, inputs)
                for s, t in zip(spec_leaves(a), tree_leaves(v))}
        outs = {id(t): t for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
        fresh = sum(_local_bytes(t) for k, t in outs.items() if k not in held)
    argument_bytes = sum(device_bytes(a, rules) for a in args)
    alias_bytes = device_bytes([held[k] for k in outs if k in held], rules)
    coll = {k: cost.collective_bytes[k] for k in COLLECTIVE_OPS}
    coll["total"] = cost.collective_total
    flops, nbytes = cost.flops, cost.bytes
    terms = roofline_terms(flops, nbytes, coll["total"])
    mf = model_flops(cfg, shape)
    peak = argument_bytes + cost.peak_bytes
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name(the_mesh),
        "chips": chips,
        "partition": "spmd" if spmd else "whole",
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": fresh,
            "temp_bytes": cost.peak_bytes,
            "alias_bytes": alias_bytes,
            "peak_estimate_bytes": peak,
            "hbm_bytes": hbm_bytes,
            "fits_hbm": peak <= hbm_bytes,
        },
        "cost": {
            "device_flops": flops,
            "device_bytes_accessed": nbytes,
            "transcendentals": cost.transcendentals,
            "matmul_flops": cost.matmul_flops,
            "aten_ops": cost.ops,
            "kernels": cost.summary()["kernels"],
        },
        "collectives": coll,
        "roofline": terms,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(flops * chips, 1e-30),
        "remat": "unit",
        "zero1": zero1,
        "param_mode": mode,
        "num_microbatches": num_microbatches,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["local", "single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the local mesh's device: cuda (every card) or cpu (the host)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, applicable_shapes

    cells: list[tuple[str, str]] = []
    if args.all:
        for a, cfg in ARCHS.items():
            for s in applicable_shapes(cfg):
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))
    meshes = {"local": ["local"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mesh in meshes:
            tag = f"{arch}__{shape}__{mesh}"
            path = out_dir / f"{tag}.json"
            if path.exists():
                print(f"[skip] {tag} (cached)", flush=True)
                continue
            print(f"[meta run] {tag} ...", flush=True)
            try:
                res = run_cell(arch, shape, mesh, zero1=args.zero1, device=args.device)
                path.write_text(json.dumps(res, indent=1))
                r = res["roofline"]
                print(
                    f"  ok {res['trace_s']:.1f}s | "
                    f"peak/dev {res['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB | "
                    f"terms c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
                    f"n={r['collective_s']:.4f} -> {r['dominant']}",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 -- report every cell, then fail
                failures.append((tag, str(e)))
                print(f"  FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, msg in failures:
            print(f"  {tag}: {msg[:200]}")
        raise SystemExit(1)
    print("\nAll dry-run cells ran.")


if __name__ == "__main__":
    main()
