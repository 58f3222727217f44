#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's file ``bench/workloads/<cell>.json``
names its configuration (``bench/configs/``), its traffic
(``bench/traffic/<traffic>.json``, read by the driver the file names,
``bench/traffic/<driver>.py``), the program's entry it drives
(``bench/entries/<entry>.py``), the metrics it reports and the limit of
each number its output check compares.  Each per-layer metric is read by
its own ``bench/metrics/<metric>.py``.

A run makes its weights and inputs from ``--seed``, builds the entry,
warms it at the cell's own shapes (that, with the imports and the kernel
library's load or build, is ``setup_s``), measures for ``--seconds``
(``--trace 1``: for the traffic's ``trace_seconds`` at most, under
``torch.profiler``), frees the program's state and holds what the window
produced to the plain reference under ``bench/reference/``.  The last
line of standard output is the result, as JSON; the numbers compared and
their limits are also the last lines of standard error.  It exits with 2
and prints no result without enough CUDA cards, and with 3 when ``jax``,
``jaxlib``, ``flax`` or ``repro`` was loaded.

What differs by architecture is found by the configuration's ``arch`` in
``bench/archs/<arch>.py``: the weights from the seed (``make_params``),
the model's FLOPs a unit of work by traffic kind (``model_flops``), the
ROBE slots a unit's ids reach (``touched``, None without a ROBE array)
and the name of its plain reference, ``bench/reference/<REFERENCE>.py``.
So a new architecture is added as new files only: ``archs/<arch>.py``
and ``reference/<arch>.py``, its configuration, its traffic file and
driver, its entry and workload file, its metric readers, and its entries
in ``BENCHMARK.json``.  The plain reference imports nothing of the
program and nothing of JAX; every function a driver calls on it takes
``(params, cfg, *inputs, device=...)``.

``--fault`` and ``--control tf32`` are for the output check's own tests:
a fault planted under the timed path (``lib/faults.py``), or the program
run with TF32 matmuls, the next precision below the configuration's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _environment() -> None:
    """Caches at fixed paths inside the checkout; ``src`` and the
    benchmark's own modules on the path."""
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str) -> SimpleNamespace:
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    wl = _json(BENCH / "workloads" / f"{name}.json")
    return SimpleNamespace(
        name=name, wl=wl, cfg=_json(BENCH / "configs" / f"{wl['config']}.json"),
        traffic=_json(BENCH / "traffic" / f"{wl['traffic']}.json"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _load(kind: str, name: str):
    """``bench/<kind>/<name>.py``, loaded by its path (a name may hold
    dots)."""
    if not NAME.match(name):
        raise ValueError(f"not a name of {kind}: {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + re.sub(r"\W", "_", name),
        BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(name: str):
    return _load("metrics", name)


def arch_of(cfg: dict):
    """The module of the configuration's architecture."""
    return _load("archs", cfg["arch"])


class Reference:
    """The plain reference of a configuration, on the weights the seed
    makes (made again, not read from the program).  Any function of the
    architecture's reference module is called with these weights, the
    configuration and the device bound: ``reference.scores(batch)``."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.arch = arch_of(cfg)

    @functools.cached_property
    def params(self) -> dict:
        return self.arch.make_params(self.cfg, self.seed, self.device)

    @functools.cached_property
    def module(self):
        name = self.arch.REFERENCE
        if not NAME.match(name):
            raise ValueError(f"not a name of a reference: {name!r}")
        return importlib.import_module("reference." + name)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = getattr(self.module, name)
        return functools.partial(fn, self.params, self.cfg,
                                 device=self.device)


class _Absent(Exception):
    """A reader asked for a count that the architecture does not have."""


class Context(SimpleNamespace):
    """What a per-layer reader reads; the model's FLOPs and the touched
    slots are worked out only when a reader asks."""

    @functools.cached_property
    def flops(self) -> dict:
        return self.arch.model_flops(self.cfg)


def per_layer(cell, win, trace, pool, device, device_name: str) -> dict:
    """Each of the cell's per-layer metrics that finds something to read.
    A reader that asks for the touched slots of an architecture without a
    ROBE array reads nothing."""
    from lib.work import peaks
    arch = arch_of(cell.cfg)
    touched = {}

    def count(i: int) -> int:
        if i not in touched:
            touched[i] = arch.touched(cell.cfg, pool[i], device)
        if touched[i] is None:
            raise _Absent(cell.cfg["arch"])
        return touched[i]

    ctx = Context(trace=trace, win=win, pool=pool, cfg=cell.cfg, arch=arch,
                  rates=peaks(device_name), touched=count)
    out = {}
    for name in cell.wl["per_layer"]:
        mod = _metric(name)
        try:
            value = mod.read(ctx)
        except _Absent:
            value = None
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             fault=None, control=None, t_start=None, marks=()) -> dict:
    """One run of ``cell``: the result line as a dict.  ``t_start`` is when
    set-up began (default: now); ``marks``, (what, when) of set-up's
    steps before the call, are printed with the rest."""
    import torch
    from lib.faults import Faulty
    from lib.trace import traced
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    lowp = control == "tf32"
    if control not in (None, "tf32"):
        raise ValueError(f"unknown control {control!r}")
    torch.backends.cuda.matmul.allow_tf32 = lowp
    torch.backends.cudnn.allow_tf32 = lowp
    driver = importlib.import_module("traffic." + cell.traffic["driver"])
    entry_mod = importlib.import_module("entries." + cell.wl["entry"])

    marks = [("start", t_start), *marks, ("imports", time.perf_counter())]
    pool = driver.inputs(cell.cfg, cell.traffic, seed)
    marks.append(("inputs", time.perf_counter()))
    entry = entry_mod.Entry(cell.cfg,
                            arch_of(cell.cfg).make_params(cell.cfg, seed,
                                                          device),
                            device, cell.wl.get("entry_options", {}))
    if fault:
        entry = Faulty(entry, fault)
    sync()
    marks.append(("weights and entry", time.perf_counter()))
    prep = driver.prepare(entry, pool, cell.traffic)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(f"{k} {t - marks[i][1]:.3f} s" for i, (k, t)
                                 in enumerate(marks[1:])), file=sys.stderr)

    tr = None
    if trace:
        from torch.profiler import record_function
        secs = min(seconds, cell.traffic["trace_seconds"])
        win, tr = traced(lambda: driver.window(entry, pool, secs,
                                               record_function, prep),
                         cuda=on_card)
    else:
        win = driver.window(entry, pool, seconds,
                            lambda _: contextlib.nullcontext(), prep)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    readings = driver.checks(win, pool, cell.traffic, seed, prep,
                             Reference(cell.cfg, seed, device))
    del prep
    limits = cell.wl["checks"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(win.units),
              "failed": int(readings["failed"])}
    if trace:
        # a CPU rehearsal reads its (host) trace against the card's peaks
        result["metrics"] = per_layer(cell, win, tr, pool, device,
                                      name if on_card else "H100")
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": [[k, v] for k, v in tr.idle_by_host[:10]]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for k, (v, unit) in driver.end_to_end(win).items():
            metrics[k] = {"value": float(v), "unit": unit}
        result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = checks
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", default=None, choices=(None, "tf32"))
    return ap.parse_args(argv)


def report(result: dict) -> None:
    """The numbers compared, as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    cell = load_cell(args.workload)
    import torch
    t_torch = time.perf_counter()
    chips = int(cell.wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    marks = (("import torch", t_torch), ("CUDA", time.perf_counter()))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), fault=args.fault,
                      control=args.control, t_start=T_START, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded were: {found}",
              file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
