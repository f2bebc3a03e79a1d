"""The port stands alone: no JAX, no JAX package, and no quiet CPU path.

* No file of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  the ``repro`` package (read from their syntax trees).
* Importing ``repro_torch`` loads no ``jax`` module.
* Entry points called with no ``device=`` raise when CUDA is absent.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_new_modules_are_checked():
    """The per-instance LP, the LP-guided order, the certificate, the
    serving path (configs, models, flash kernel, serve), the flow-space
    calendar's kernel, xLSTM (config, blocks, mLSTM kernel) and the
    training path (quant kernels, compression, AdamW, data, steps, train)
    and the baselines' oracles and stages (BvN, EPS, allocation, circuit,
    scheduler, stages), and refinement, the calendar's executors and the
    collective planner (localsearch, refine, batch_circuit, pipeline,
    spec, ensemble_batch, planner), and the streaming service and its
    arrival generators (pool, service, arrivals, results), and the
    experiment fabric (ensemble, cache, sweep, runner, mesh), and
    checkpointing, failure recovery and the RG-LRU family (checkpointer,
    fault_tolerance, rglru, its config), and the remaining families (moe,
    the MLA, MoE, vision and audio configs), and the launch tooling
    (sharding, specs, op_cost, roofline, dryrun, perf, report) are among
    the files the syntax check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in (
        "core/lp.py", "core/ordering.py", "core/lower_bounds.py", "core/theory.py",
        "configs/base.py", "configs/__init__.py", "configs/gemma3_1b.py",
        "kernels/flash_attention.py", "models/layers.py", "models/model.py",
        "launch/serve.py", "kernels/event_resolve.py",
        "configs/xlstm_1_3b.py", "models/xlstm.py", "kernels/mlstm_chunk.py",
        "kernels/quant.py", "runtime/compression.py", "optim/adamw.py",
        "data/pipeline.py", "launch/steps.py", "launch/train.py", "tree.py",
        "core/bvn.py", "core/eps.py", "core/allocation.py", "core/circuit.py",
        "core/scheduler.py", "pipeline/stages.py",
        "core/localsearch.py", "pipeline/refine.py", "pipeline/batch_circuit.py",
        "pipeline/pipeline.py", "pipeline/spec.py", "pipeline/ensemble_batch.py",
        "collectives/__init__.py", "collectives/planner.py",
        "streaming/__init__.py", "streaming/pool.py", "streaming/service.py",
        "traffic/arrivals.py", "experiments/results.py",
        "experiments/ensemble.py", "experiments/cache.py", "experiments/sweep.py",
        "experiments/runner.py", "launch/mesh.py",
        "checkpoint/__init__.py", "checkpoint/checkpointer.py", "runtime/fault_tolerance.py",
        "models/rglru.py", "configs/recurrentgemma_2b.py",
        "models/moe.py", "configs/minicpm3_4b.py", "configs/dbrx_132b.py",
        "configs/qwen3_moe_235b_a22b.py", "configs/llama_3_2_vision_11b.py",
        "configs/musicgen_medium.py",
        "launch/sharding.py", "launch/specs.py", "launch/op_cost.py", "launch/roofline.py",
        "launch/dryrun.py", "launch/perf.py", "launch/report.py",
    ):
        assert f"src/repro_torch/{mod}" in names


def test_import_loads_no_jax():
    code = (
        "import sys, repro_torch.pipeline, repro_torch.experiments, "
        "repro_torch.convert, repro_torch.traffic, repro_torch.core.ordering, "
        "repro_torch.core.lower_bounds, repro_torch.core.theory, "
        "repro_torch.configs, repro_torch.models, repro_torch.models.xlstm, "
        "repro_torch.kernels.mlstm_chunk, repro_torch.launch.serve, "
        "repro_torch.kernels.quant, repro_torch.runtime.compression, "
        "repro_torch.optim, repro_torch.data.pipeline, repro_torch.launch.train, "
        "repro_torch.core.bvn, repro_torch.core.eps, repro_torch.core.localsearch, "
        "repro_torch.pipeline.refine, repro_torch.collectives.planner, "
        "repro_torch.streaming, repro_torch.traffic.arrivals, "
        "repro_torch.experiments.results, repro_torch.experiments.cache, "
        "repro_torch.experiments.sweep, repro_torch.experiments.runner, "
        "repro_torch.launch.mesh, repro_torch.checkpoint, "
        "repro_torch.runtime.fault_tolerance, repro_torch.models.rglru, "
        "repro_torch.models.moe, repro_torch.launch.sharding, repro_torch.launch.specs, "
        "repro_torch.launch.op_cost, repro_torch.launch.roofline, repro_torch.launch.dryrun, "
        "repro_torch.launch.perf, repro_torch.launch.report; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.core import lp
    from repro_torch.core.ordering import lp_guided_order
    from repro_torch.experiments import solve_ensemble_lp
    from repro_torch.launch import train
    from repro_torch.launch.serve import main, serve
    from repro_torch.models import build_model
    from repro_torch.collectives.planner import GradientBucket, plan
    from repro_torch.experiments import run_distributed, run_shard, stream, sweep
    from repro_torch.pipeline import build_ensemble_batch, get_pipeline
    from repro_torch.pipeline.ensemble_batch import build_slot_pool_batch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_local_mesh, place

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("gemma3-1b").reduced()
    xlstm = get_arch("xlstm-1.3b")
    inst = from_reference(random_instance(num_coflows=3, num_ports=2, seed=0), "cpu")
    sol = lp.LPSolution(
        completion=[1.0, 2.0, 3.0], precedence=None, objective=0.0, method="x"
    )
    calls = [
        lambda: solve_ensemble_lp([inst]),
        lambda: build_ensemble_batch([inst]),
        lambda: get_pipeline("ours").run_batch([inst], [sol]),
        lambda: lp.pack_lp_arrays([inst]),
        lambda: lp.solve_subgradient_batch([inst]),
        lambda: lp.solve_subgradient(inst),
        lambda: lp_guided_order(inst),
        lambda: lp_guided_order(inst, method="subgradient"),
        lambda: get_pipeline("ours").run(inst),
        lambda: get_pipeline("ours").run(inst, sol),
        lambda: get_pipeline("ours", circuit_engine="jax").run(inst, sol),
        lambda: get_pipeline("ours", circuit_engine="jax").run_batch([inst], [sol]),
        lambda: get_pipeline("ours", lp_method="subgradient").run_batch([inst]),
        lambda: get_pipeline("ours").order_stage.order(inst),
        lambda: build_model(cfg),
        lambda: serve(cfg, None, slots=1, requests=1, prompt_len=2, max_new=1, seed=0),
        lambda: main(["--requests", "1", "--prompt-len", "2", "--max-new", "1"]),
        lambda: build_model(xlstm),
        lambda: serve(xlstm, None, slots=1, requests=1, prompt_len=2, max_new=1, seed=0),
        lambda: main(["--arch", "xlstm-1.3b", "--requests", "1", "--prompt-len", "2",
                      "--max-new", "1"]),
        lambda: train.main(["--arch", "gemma3-1b", "--steps", "1", "--compress-grads"]),
        lambda: train.train(cfg, steps=1, batch=1, seq=4, compress_grads=True),
        lambda: get_pipeline("ours_ls").run_batch([inst], [sol]),
        lambda: get_pipeline("ours").run(inst, sol, refine=True),
        lambda: get_pipeline("ours", circuit_engine="wide").run_batch([inst], [sol]),
        lambda: get_pipeline("ours", circuit_backend="loop").run_batch([inst], [sol]),
        lambda: plan([GradientBucket("b0", 1 << 20, 0.0)]),
        lambda: train.main(["--arch", "gemma3-1b", "--steps", "1", "--plan-collectives"]),
        lambda: stream(inst),
        lambda: stream(inst, lp_method="exact"),
        lambda: stream(inst, lp_method="exact", epoch_mode="rebuild", pool_size=2),
        lambda: build_slot_pool_batch(4, 2, inst.rates, inst.delta),
        lambda: sweep([inst]),
        lambda: sweep([inst], lp_method="exact", schemes=("ours",)),
        lambda: sweep([inst], lp_method="subgradient", alloc="loop"),
        lambda: run_shard([{}], lambda spec: inst, schemes=("ours",)),
        lambda: run_distributed([{}], lambda spec: inst, name="x", schemes=("ours",)),
        lambda: train.main(["--arch", "xlstm-1.3b", "--steps", "1", "--inject-failure", "1",
                            "--checkpoint-dir", "unused"]),
        lambda: train.train(xlstm, steps=1, batch=1, seq=4, checkpoint_dir="unused"),
        lambda: build_model(get_arch("recurrentgemma-2b")),
        lambda: main(["--arch", "recurrentgemma-2b", "--requests", "1", "--prompt-len", "2",
                      "--max-new", "1"]),
        *(lambda a=arch: build_model(get_arch(a))
          for arch in ("minicpm3-4b", "qwen3-moe-235b-a22b", "llama-3.2-vision-11b")),
        *(lambda a=arch: main(["--arch", a, "--requests", "1", "--prompt-len", "2",
                               "--max-new", "1"])
          for arch in ("minicpm3-4b", "dbrx-132b", "llama-3.2-vision-11b", "musicgen-medium")),
        lambda: train.main(["--arch", "musicgen-medium", "--steps", "1"]),
        lambda: make_local_mesh(),
        lambda: place([1.0]),
        lambda: run_cell("gemma3-1b", "decode_32k", "local"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_from_reference_round_trips_fields():
    ref = random_instance(num_coflows=4, num_ports=3, seed=2, release_span=5.0)
    inst = from_reference(ref, "cpu")
    for f in ("demands", "weights", "releases", "rates"):
        assert getattr(inst, f).tobytes() == getattr(ref, f).tobytes()
    assert inst.delta == ref.delta
    with pytest.raises(TypeError, match="no counterpart"):
        from_reference(object(), "cpu")
