"""The benchmark of ``cruise_control_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``), from the root of a checkout.  A cell
is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/mixes/<traffic>.json``), with the limits of its
correctness check in ``portbench/cells/<cell>.json``.  The mix names the
entry the window drives (``portbench/entries/<entry>.py``); each metric is
read by ``portbench/metrics/<metric>.py``.  A later cell, mix or metric is a
new file and a new entry in ``BENCHMARK.json``.

A run, in order: build the program's kernels into the checkout's
``build/kernels/`` (later runs find them there); make the cell's pool of
inputs; warm up with whole passes over them for at least ``WARM_S`` seconds
(the first call captures the goal graphs); drive the entry in whole passes (one call on each input, in the
order ``--seed`` gives) until ``--seconds`` have passed; then hold every proposal the window delivered against the plain
reference (``portbench/reference``), and print one JSON line.  With
``--trace 1`` the per-layer metrics are read instead of the end-to-end ones,
the window's first pass is traced with ``torch.profiler``, and the window
runs at least one pass after it.

A run needs a CUDA card and fails without one; it never falls back to the
CPU.  It fails, too, if JAX or the JAX package (``cruise_control_tpu``) is
loaded in its process, and when the program is missing from the checkout.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the program's caches, at fixed paths inside the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench/triton",
    "CUDA_CACHE_PATH": "build/portbench/cuda_cache",
}
#: the least seconds of warm-up passes before the window
WARM_S = 12.0
#: the program's kernel sources, built once a checkout (``ops/_build.py``)
KERNELS = ("segment_sum", "graph_loop", "even_assign")


class RunFailed(Exception):
    """A run that must exit without a result line."""


def _prepare_environment(root: Path) -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(root / rel)
    # the program's own switches keep their defaults in every run
    for key in [k for k in os.environ if k.startswith("CC_TPU_")]:
        del os.environ[key]


if __name__ == "__main__":
    _prepare_environment(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

from portbench import guard  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.traffic import load_mix, make_inputs, order  # noqa: E402


def load_module(path: Path, name: str):
    """A module of the harness found by its file (an entry or a metric)."""
    if not path.is_file():
        raise RunFailed(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell and every file it names."""

    root: Path
    workload: dict
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise RunFailed(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    pb = root / "portbench"
    config = json.loads((pb / "configs" / f"{w['config']}.json").read_text())
    mix = load_mix(w["traffic"], pb / "traffic" / "mixes")
    cell = json.loads((pb / "cells" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(
        root=root, workload=w, config=config, mix=mix, limits=cell["limits"],
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def lower_precision(arrays: dict) -> dict:
    """The arrays with every load rounded to bfloat16 (nearest, ties to
    even): the control's input, the step below the float32 the
    configuration states."""
    import numpy as np

    out = dict(arrays)
    for k in ("base_load", "leadership_delta"):
        bits = np.ascontiguousarray(arrays[k], np.float32).view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
        out[k] = bits.astype(np.uint32).view(np.float32)
    return out


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read of a run."""

    cell: Cell
    seed: int
    trace: bool
    device: object
    setup_s: float = 0.0
    window_s: float = 0.0
    passes: int = 0
    calls: list = dataclasses.field(default_factory=list)
    #: each call's wall (host clock, s)
    call_s: list = dataclasses.field(default_factory=list)
    first_pass: list = dataclasses.field(default_factory=list)
    judged: list = dataclasses.field(default_factory=list)
    #: the program's counters over the window (``ops.graph_loop.LAUNCHES`` deltas)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the goal graphs' device time over the window's passes after the traced
    #: one (traced runs), and the round trips those passes ran
    graph_s: Optional[float] = None
    graph_trips: int = 0
    #: the traced pass (``trace.Reading``)
    reading: object = None
    #: what a metric module's ``before_window`` leaves for its ``read``
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)
    inputs: list = dataclasses.field(default_factory=list)
    entry: object = None


def _metric_modules(run: Run, metrics: List[dict]):
    pb = run.cell.root / "portbench" / "metrics"
    return [(m, load_module(pb / f"{m['name']}.py", f"portbench_metric_{m['name'].replace('.', '_')}"))
            for m in metrics]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _window(run: Run, entry, cycle: List[int], seconds: float, fault) -> None:
    """Drive ``entry`` in whole passes over the inputs, in the order
    ``cycle``, until ``seconds`` have passed.  With ``run.trace`` the first
    pass is traced, and the goal graphs are timed over the passes after it,
    of which there is at least one: the profiler slows the graphs it
    watches, so the traced pass would read slower rounds the fewer passes
    follow it."""
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from portbench import trace as T

    timer = T.GraphTimer() if run.trace else contextlib.nullcontext()
    first_timed, trips0 = 0, 0
    with timer:
        t0 = time.monotonic()
        run.setup_s = t0 - T_START
        while True:
            profiled = run.trace and run.passes == 0
            traced = T.Profiled(timer) if profiled else contextlib.nullcontext()
            with traced:
                for i in cycle:
                    c0 = time.monotonic()
                    call = entry.call(i)
                    run.call_s.append(time.monotonic() - c0)
                    if fault is not None:
                        fault(run, call)
                    run.calls.append(call)
            if profiled:
                run.reading = traced.reading
                first_timed, trips0 = len(timer.windows), GL.LAUNCHES["round_trips"]
            run.passes += 1
            if time.monotonic() - t0 >= seconds and (not run.trace or run.passes >= 2):
                break
        run.window_s = time.monotonic() - t0
    if run.trace:
        run.graph_s = timer.seconds(first_timed)
        run.graph_trips = GL.LAUNCHES["round_trips"] - trips0


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False, fault=None, data_seed: Optional[int] = None):
    """One run of a cell on ``device``: returns ``(result dict, run)``.
    The inputs are the mix's pool (``data_seed`` draws another pool), cycled
    in the order ``seed`` gives.  ``control`` feeds the program loads rounded
    to bfloat16; ``fault(run, call)`` (tests only) breaks each call's
    delivered proposals.  ``control``, ``data_seed`` and ``fault`` serve the
    tests that set the limits; a benchmark run sets none of them.  A metric
    of the cell with no reading raises :class:`RunFailed`."""
    import torch

    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.ops import _build

    cell = load_cell(Path(root), workload)
    run = Run(cell=cell, seed=seed, trace=trace, device=device)
    metrics = cell.per_layer if trace else cell.end_to_end
    modules = _metric_modules(run, metrics)

    if device.type == "cuda":
        _build.build_all(KERNELS)
    pool = cell.mix["pool_seed"] if data_seed is None else data_seed
    run.inputs = make_inputs(cell.config["spec"], cell.mix, pool)
    program_inputs = run.inputs
    if control:
        program_inputs = [dataclasses.replace(i, lanes=[lower_precision(a) for a in i.lanes]) for i in run.inputs]
    entry_mod = load_module(cell.root / "portbench" / "entries" / f"{cell.mix['entry']}.py",
                            f"portbench_entry_{cell.mix['entry']}")
    entry = run.entry = entry_mod.Entry(cell.config, cell.mix, program_inputs, device)
    # warm-up: whole passes over the inputs for at least WARM_S seconds.  The
    # first call captures the goal graphs; the rest keep the card under load
    # until it runs as fast as it will in the window (with one call, or one
    # pass of 4 s, a window's first seconds ran 5-10 % slower)
    w0 = time.monotonic()
    while True:
        for i in range(len(run.inputs)):
            entry.call(i)
        if time.monotonic() - w0 >= WARM_S:
            break
    _sync(device)
    for _, mod in modules:
        hook = getattr(mod, "before_window", None)
        if hook is not None:
            hook(run)
    _sync(device)

    n_inputs = len(run.inputs)
    before = dict(GL.LAUNCHES)
    _window(run, entry, order(seed, n_inputs), seconds, fault)
    run.counters = {k: GL.LAUNCHES[k] - before.get(k, 0) for k in GL.LAUNCHES}
    memory_peak = int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0

    # the check: every delivered proposal against the plain reference
    claims = entry.claims(run.calls)
    goals, hard = cell.mix["goals"], [g for g in cell.config["hard_goals"] if g in cell.mix["goals"]]
    heavy = bool(cell.mix["heavy_goals"])
    failed = 0
    for call, cl in zip(run.calls, claims):
        judged = []
        for p, c in zip(call.proposals, cl):
            inp = run.inputs[p.input_index].lanes[p.lane]
            j = compare.judge_proposal(inp, p.placement, c, goals, hard, cell.config["constraint"], heavy)
            failed += compare.failed(j, cell.limits)
            judged.append(j)
        run.judged.append(judged)
    first = sorted(zip(run.calls[:n_inputs], run.judged[:n_inputs]), key=lambda cj: cj[0].input_index)
    run.first_pass = [j for _, js in first for j in js]
    worst = compare.worst([j for js in run.judged for j in js])
    checks = {k: {"value": worst[k], "limit": float(cell.limits[k])} for k in compare.NUMBERS}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    values = {}
    missing = []
    for m, mod in modules:
        v = mod.read(run)
        if v is None:
            missing.append(m["name"])
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}
    if missing:
        # a metric whose source went silent fails the run; it is never left out or read as 0
        raise RunFailed(f"no reading for {', '.join(missing)}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": sum(len(c.proposals) for c in run.calls),
              "failed": int(failed), "metrics": values, "device": dev}
    if trace and run.reading is not None:
        dev["busy_s"] = run.reading.busy_s
        dev["window_s"] = run.reading.window_s
        result["breakdown"] = {"device_ops": run.reading.device_ops, "idle_gaps": run.reading.idle_gaps}
    result["checks"] = checks
    return result, run


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_program(root: Path) -> None:
    """The program must be the checkout's own."""
    try:
        import cruise_control_tpu_torch
    except ImportError as e:
        raise RunFailed(f"the program is missing from the checkout: {e}")
    where = Path(cruise_control_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise RunFailed(f"the program was loaded from {where}, outside the checkout {root}")


def main(argv=None) -> int:
    args = parse(argv)
    try:
        loaded = guard.forbidden_modules()
        if loaded:
            raise RunFailed(f"loaded before the run: {', '.join(loaded)}")
        cell = load_cell(ROOT, args.workload)
        import torch

        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunFailed(f"the cell needs {chips} CUDA device(s); "
                            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        check_program(ROOT)
        result, run = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0))
        # what the run loaded, the window and the check included
        loaded = guard.forbidden_modules()
        if loaded:
            raise RunFailed(f"the run loaded {', '.join(loaded)}")
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"portbench: {len(run.calls)} calls in {run.passes} passes, {run.window_s:.3f} s; walls "
          + " ".join(f"{s:.3f}" for s in run.call_s), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
