"""A copy of the benchmark in a temporary directory, with cells of its own
added as files, and runs of it in a fresh process on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` (without its build cache) under
    ``dest``, with the program beside them as a link."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    os.symlink(REPO / "xsmm_tpu_torch", dest / "xsmm_tpu_torch")
    return dest


def add_cell(root: Path, name: str, config: str, traffic: str,
             config_data: dict | None = None,
             traffic_data: dict | None = None,
             limits_of: str | None = None) -> None:
    """Add cell ``name`` to the copy by new files and new entries only:
    the config and traffic files where given, and the limits of cell
    ``limits_of``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config_data is not None:
        path = f"portbench/configs/{config}.json"
        (root / path).write_text(json.dumps(config_data))
        bench["configs"].append({"name": config, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    if traffic_data is not None:
        (root / "portbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_data))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    if limits_of is not None:
        shutil.copy(root / "portbench" / "limits" / f"{limits_of}.json",
                    root / "portbench" / "limits" / f"{name}.json")


def small(root: Path, real: str, name: str, **sizes) -> None:
    """Cell ``name``: the real cell ``real`` at smaller sizes (config keys
    or traffic keys in ``sizes``), under the real cell's limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == real)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    for key, value in sizes.items():
        (config if key in config else traffic)[key] = value
    traffic.update(calls_per_step=min(traffic["calls_per_step"], 3),
                   trace_steps=2)
    stem = name.replace(".", "_")
    add_cell(root, name, f"{stem}_cfg", f"{stem}_mix",
             config_data=config, traffic_data=traffic, limits_of=real)


def run_script(root: Path, body: str, timeout: float = 600) -> list:
    """Run ``body`` in a fresh Python process with the copy first on the
    path and ``run`` imported; returns the JSON lines it printed."""
    prelude = ("import json, sys\n"
               f"sys.path.insert(0, {str(root)!r})\n"
               "from portbench import run, guard\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("XSMM_")}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", prelude + body], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
