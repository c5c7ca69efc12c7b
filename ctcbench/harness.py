"""One run of one cell: set-up, the measured window, the metrics, the check.

A driver (``drivers/<kind>.py``) exposes ``Driver(cell, seed, device,
tracer, log)`` with:

- ``setup()``: makes the inputs from the seed and warms up every shape the
  window will use;
- ``window(seconds)``: the measured window; returns a ``Window``;
- ``roles``: the program's span names this entry records, by role
  (``detok``, ``pad``, ``device``), and ``work``: the roofline work done in
  the window, by kind (``beam``, ``duplex``), as ``(bytes, ops)``;
- ``counters()``: the program's counters this entry moves;
- ``release()``: frees the program's state once the window has closed;
- ``check()``: the ``checks.Check`` list that decides ``correct``;
- ``close()``: stops whatever it started.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .trace import TraceSummary, Tracer


@dataclass
class Window:
    seconds: float  # the window's whole time
    attempted: int
    failed: int
    end_to_end: Dict[str, float] = field(default_factory=dict)


@dataclass
class LayerView:
    """What the per-layer readers read (``metrics/<family>.py``:
    ``read(name, view)`` returns a number, or None where there is nothing
    to read)."""

    window_s: float
    stages: Dict[str, float]  # program span seconds inside the window
    roles: Dict[str, str]
    counters: Dict[str, float]  # change of the program's counters
    work: Dict[str, tuple]
    trace: Optional[TraceSummary]

    def stage_share(self, role: str) -> Optional[float]:
        stage = self.roles.get(role)
        if stage is None or stage not in self.stages or self.window_s <= 0:
            return None
        return 100.0 * self.stages[stage] / self.window_s


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log):
    """Run ``cell`` once; returns the result object (without ``checks``)
    and the checks."""
    import torch

    from fast_ctc_decode_tpu_torch.utils import profiling

    from . import spec

    tracer = Tracer(trace)
    drv = cell.driver().Driver(cell, seed, device, tracer, log)
    try:
        drv.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        log(f"setup: {setup_s:.3f} s")
        stages0, counters0 = dict(profiling.METRICS.stages), drv.counters()
        with tracer.window():
            win = drv.window(seconds)
        stages, counters = _delta(profiling.METRICS.stages, stages0), _delta(drv.counters(),
                                                                           counters0)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        summary = tracer.summarise() if trace else None
        if summary is not None:
            log(f"trace: window {summary.window_s:.3f} s, busy {summary.busy_s:.3f} s, kernels "
                f"{summary.kernel_s:.3f} s, events {summary.kinds}")
        log(f"window: {win.seconds:.3f} s, attempted {win.attempted}, failed {win.failed}, "
            f"program spans {stages}, counters {counters}")
        drv.release()
        t0 = time.perf_counter()
        checks = drv.check()
        log(f"reference and check: {time.perf_counter() - t0:.3f} s")
    finally:
        drv.close()

    metrics = {}
    if not trace:
        values = dict(win.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            v = values[m["name"]]  # a tail of requests that never came is inf: no number
            metrics[m["name"]] = {"value": v if math.isfinite(v) else None, "unit": m["unit"]}
    else:
        view = LayerView(win.seconds, stages, drv.roles, counters, drv.work, summary)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(m["name"], view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    return result, checks
