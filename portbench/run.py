#!/usr/bin/env python3
"""The benchmark of xsmm_tpu_torch on the card: one cell, run once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<traffic>.json``), whose ``driver`` names the module
of ``drivers/`` that drives one entry point of xsmm_tpu_torch.  The run:

1. sets the configuration's ``XSMM_*`` settings and clears every other,
   points the program's build cache at ``portbench/.build/``, makes the
   inputs from ``--seed`` on the card and warms the cell's shapes up (all
   of it set-up, ``setup_s``);
2. measures a closed loop with one caller for ``--seconds``: a step is the
   dispatch lookup, ``calls_per_step`` calls on operands that stay on the
   card, cycling through ``inputs.SETS`` operand sets, and a synchronize;
   a step's results are held until it ends;
3. with ``--trace 1``, runs ``trace_steps`` more steps under
   ``torch.profiler`` recording the card's activity alone, then as many
   again with the host's events and spans, and reads the per-layer metrics
   (``layer_metrics/<name>.py``) and the breakdown from those captures and
   from the measured window's host spans;
4. frees the inputs and compares the last step's outputs and a sample of
   earlier ones, drawn from the seed, with the plain reference
   (``reference/``), each number against its limit (``limits/<cell>.json``);
5. prints the numbers compared, with their limits, as the last lines of
   standard error, and one JSON line as the last line of standard output.

It refuses to run (exit code 2, no result) without enough CUDA cards, or
where xsmm_tpu_torch is not this checkout's; and (exit code 3, no result)
where JAX, jaxlib, flax or xsmm_tpu were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = HERE / ".build"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, guard, inputs, roofline, trace_reader  # noqa: E402

# every cache of the program and its tools at a fixed path in the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
             "TRITON_CACHE_DIR": BUILD / "triton",
             "CUDA_CACHE_PATH": BUILD / "nv"}
KEEP = 2          # earlier outputs kept for the check, besides the last step's
WARMUP_STEPS = 3  # steps of set-up that run the cell's shapes


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(bench: dict, workload: str) -> SimpleNamespace:
    """The cell ``workload`` with its config, traffic, driver module name
    and limits file, all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return SimpleNamespace(cell=cell, config=config, traffic=traffic,
                           driver=f"portbench.drivers.{traffic['driver']}",
                           limits=HERE / "limits" / f"{workload}.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def apply_settings(settings: dict, target: str) -> dict:
    """Clear every ``XSMM_*`` variable, set the configuration's (and, for
    a CPU run, ``XSMM_TARGET=cpu``), and make the program's config read
    them.  Returns what was set."""
    for key in [k for k in os.environ if k.startswith("XSMM_")]:
        del os.environ[key]
    env = {k: str(v) for k, v in settings.items()}
    if target == "cpu":
        env["XSMM_TARGET"] = "cpu"
    os.environ.update(env)
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.core.config import Config

    xp.set_config(**dataclasses.asdict(Config.from_env()))
    xp.enable_compile_cache(str(BUILD))
    return env


class Stats:
    """What one window records: step, lookup and issue times, calls."""

    def __init__(self):
        self.step_ns, self.lookup_ns, self.issue_ns = [], [], []
        self.calls = 0
        self.ns = 0


def _no_span(name: str):
    return contextlib.nullcontext()


class Loop:
    """The closed loop of one caller, and the outputs kept for the check,
    each with its operand set: those of the last step and a reservoir of
    ``KEEP`` earlier ones, drawn from the seed."""

    def __init__(self, drv, sync, seed: int):
        self.drv, self.sync = drv, sync
        self.rng = random.Random(seed)
        self.kept, self.last = [], []
        self.seen = 0
        self.n_calls = 0

    def step(self, stats: Stats, span=_no_span) -> None:
        """One step; ``span`` names its lookup and calls in a trace."""
        drv = self.drv
        clock = time.perf_counter_ns
        self.last = outs = []
        t0 = clock()
        with span("portbench.lookup"):
            handle = drv.lookup()
        t1 = clock()
        issue = []
        for _ in range(drv.calls_per_step):
            s = self.n_calls % inputs.SETS
            self.n_calls += 1
            c0 = clock()
            with span("portbench.call"):
                outs.append((s, drv.call(handle, s)))
            issue.append(clock() - c0)
        self.sync()
        t2 = clock()
        stats.step_ns.append(t2 - t0)
        stats.lookup_ns.append(t1 - t0)
        stats.issue_ns.extend(issue)
        stats.calls += len(outs)
        for out in outs:
            if len(self.kept) < KEEP:
                self.kept.append(out)
            else:
                r = self.rng.randrange(self.seen + 1)
                if r < KEEP:
                    self.kept[r] = out
            self.seen += 1

    def run_for(self, seconds: float, stats: Stats) -> None:
        start = time.perf_counter_ns()
        limit = int(seconds * 1e9)
        while True:
            self.step(stats)
            stats.ns = time.perf_counter_ns() - start
            if stats.ns >= limit:
                return

    def outputs(self) -> list:
        extra = [o for o in self.kept if all(o is not x for x in self.last)]
        return self.last + extra


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def traced(loop: Loop, steps: int, cuda: bool, port_names):
    """Two captures of ``steps`` steps each: the card's activity alone
    (busy and idle time, device operations), then with the host's events
    and spans (what the host did in each idle gap).  (steps and calls of
    the first, calls of both, the summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = loop.sync
    dev_stats, host_stats = Stats(), Stats()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        sync()
        start = time.perf_counter_ns()
        for _ in range(steps):
            loop.step(dev_stats)
        window_ns = time.perf_counter_ns() - start
    summary = trace_reader.summarize(prof.profiler.kineto_results.events(),
                                     window_ns, port_names)
    del prof
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            for _ in range(steps):
                loop.step(host_stats, record_function)
    summary.idle_by_host = trace_reader.idle_by_host(
        prof.profiler.kineto_results.events(), "portbench.window")
    return (len(dev_stats.step_ns), dev_stats.calls,
            dev_stats.calls + host_stats.calls, summary)


def read_metrics(entries, workload: str, package: str, ctx) -> dict:
    """{name: {"value", "unit", ...}} of the entries that apply to the
    cell and whose reader finds something to read."""
    out = {}
    for m in entries:
        if not applies(m, workload):
            continue
        got = importlib.import_module(f"{package}.{m['name']}").read(ctx)
        if got is None:
            continue
        extra = got if isinstance(got, dict) else {"value": got}
        out[m["name"]] = {"value": float(extra["value"]), "unit": m["unit"],
                          **{k: v for k, v in extra.items() if k != "value"}}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, control: bool = False,
             steps: int = 0, judge: bool = True):
    """Run cell ``workload`` once: (the result, the last line's object;
    what else the run knows: the readings an output under ``numbers``, the
    ``settings`` set and the ``steps`` measured).  ``steps`` > 0 runs that
    many steps in place of ``seconds``; ``control`` puts the driver's
    control in the program's place (``readings.py``); ``judge=False``
    compares no limits."""
    bench = load_bench()
    spec = resolve(bench, workload)
    settings = apply_settings(spec.config.get("settings", {}), device)
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spans: dict = {}
    driver = importlib.import_module(spec.driver)
    drv = driver.Driver(spec.config, spec.traffic, dev, seed,
                        control=control, spans=spans)
    loop = Loop(drv, sync, seed)
    for _ in range(WARMUP_STEPS):
        loop.step(Stats())
    loop.kept, loop.last, loop.seen = [], [], 0
    sync()
    gc.collect()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START

    stats = Stats()
    gc.disable()
    try:
        if steps:
            start = time.perf_counter_ns()
            for _ in range(steps):
                loop.step(stats)
            stats.ns = time.perf_counter_ns() - start
        else:
            loop.run_for(seconds, stats)
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        summary = None
        trace_steps = trace_calls = traced_calls = 0
        if trace:
            import xsmm_tpu_torch

            csrc = Path(xsmm_tpu_torch.__file__).parent / "ops" / "csrc"
            trace_steps, trace_calls, traced_calls, summary = traced(
                loop, int(spec.traffic["trace_steps"]), cuda,
                trace_reader.port_kernel_names(csrc))
    finally:
        gc.enable()
    memory_peak = (max(setup_peak, torch.cuda.max_memory_allocated(dev))
                   if cuda else 0)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    ctx = SimpleNamespace(
        workload=workload, config=spec.config, traffic=spec.traffic,
        setup_s=setup_s, step_ns=stats.step_ns, window_ns=stats.ns,
        calls=stats.calls, lookup_ns=stats.lookup_ns,
        issue_ns=stats.issue_ns, spans=spans,
        ops_per_call=drv.ops_per_call, bytes_per_call=drv.bytes_per_call,
        window_peak_bytes=window_peak, trace=summary,
        trace_steps=trace_steps, trace_calls=trace_calls,
        peaks=roofline.peaks(kind) if cuda and trace else None)
    if trace:
        metrics = read_metrics(bench["per_layer"], workload,
                               "portbench.layer_metrics", ctx)
    else:
        metrics = read_metrics(bench["end_to_end"], workload,
                               "portbench.e2e_metrics", ctx)

    # the check: the program's inputs freed, its kept outputs against the
    # reference, after the peak was read
    outputs = loop.outputs()
    by_set = {}
    for s, _ in outputs:
        by_set[s] = by_set.get(s, 0) + 1
    loop.kept = loop.last = []
    drv.release()
    gc.collect()
    numbers = drv.check(outputs)
    del outputs
    if judge:
        ok, failed, checks = check.judge(numbers,
                                         check.load_limits(spec.limits))
    else:
        ok, failed, checks = None, 0, {}

    result = {"correct": ok,
              "attempted": stats.calls + traced_calls,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": int(spec.cell["chips"]),
                         "memory_peak_bytes": int(memory_peak),
                         "power_limit": power_limit() if cuda else None}}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_ns / 1e9
        result["device"]["window_s"] = summary.window_ns / 1e9
        result["breakdown"] = {
            "device_ops": trace_reader.top(summary.device_ns),
            "idle_gaps": trace_reader.top(summary.idle_by_host)}
    result["checks"] = checks
    return result, {"numbers": numbers, "settings": settings,
                    "steps": len(stats.step_ns), "by_set": by_set}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    spec_pkg = importlib.util.find_spec("xsmm_tpu_torch")
    if spec_pkg is None or Path(spec_pkg.origin).resolve().parent != (
            ROOT / "xsmm_tpu_torch").resolve():
        print(f"portbench: xsmm_tpu_torch is not in this checkout ({ROOT})",
              file=sys.stderr)
        return 2
    chips = int(resolve(load_bench(), args.workload).cell["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s), this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, info = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{result['device']['kind']} at {result['device']['power_limit']}, "
          f"settings {info['settings']}, {info['steps']} steps, outputs "
          f"checked by operand set {info['by_set']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
