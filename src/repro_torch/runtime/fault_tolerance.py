"""Fault tolerance & elasticity for long-running training (a copy of
``repro.runtime.fault_tolerance``; plain Python).

  * HeartbeatMonitor — tracks per-host liveness; a host that misses
    ``dead_after`` seconds of beats is declared failed.
  * StragglerPolicy — per-step duration tracking with a robust (median +
    k*MAD) deadline; hosts that exceed it repeatedly are flagged for
    replacement BEFORE they fail hard (slow HBM, thermal throttle).
    ``launch/train.py`` records every step's time in one.
  * run_resilient_loop — the supervisor: run step -> on failure, restore
    from the last atomic checkpoint -> continue.  The deterministic data
    pipeline (seed, step) makes recovery bit-exact.
  * plan_elastic_remesh — given the surviving device count, the largest
    (data, model) mesh that keeps the model axis (the data axis shrinks);
    its ``mesh_shape`` is the one ``launch.mesh.make_local_mesh`` builds
    over the ranks kept.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], dead_after: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.dead_after = dead_after
        self.clock = clock
        self.last_beat: Dict[str, float] = {h: clock() for h in hosts}

    def beat(self, host: str) -> None:
        self.last_beat[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.dead_after]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


class StragglerPolicy:
    """Flag hosts whose step times are persistent outliers."""

    def __init__(self, tolerance: float = 3.0, window: int = 32,
                 strikes_to_flag: int = 3):
        self.tolerance = tolerance
        self.window = window
        self.strikes_to_flag = strikes_to_flag
        self.history: Dict[str, List[float]] = {}
        self.strikes: Dict[str, int] = {}

    def record(self, host: str, step_time: float) -> None:
        h = self.history.setdefault(host, [])
        h.append(step_time)
        if len(h) > self.window:
            h.pop(0)

    def deadline(self) -> Optional[float]:
        all_times = sorted(t for h in self.history.values() for t in h)
        if len(all_times) < 8:
            return None
        mid = all_times[len(all_times) // 2]
        mad = sorted(abs(t - mid) for t in all_times)[len(all_times) // 2]
        return mid + self.tolerance * max(mad, 0.05 * mid)

    def update_strikes(self) -> List[str]:
        """Call once per step after records; returns flagged hosts."""
        dl = self.deadline()
        if dl is None:
            return []
        flagged = []
        for host, h in self.history.items():
            if h and h[-1] > dl:
                self.strikes[host] = self.strikes.get(host, 0) + 1
            else:
                self.strikes[host] = 0
            if self.strikes.get(host, 0) >= self.strikes_to_flag:
                flagged.append(host)
        return flagged


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    dropped_devices: int

    @property
    def devices(self) -> int:
        return self.data * self.model

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        """(data, model): what ``launch.mesh.make_local_mesh(model)``
        builds over a world of the ``devices`` ranks kept
        (``mesh_shape_for(devices, model)``)."""
        return (self.data, self.model)


def plan_elastic_remesh(surviving_devices: int, model_axis: int
                        ) -> RemeshPlan:
    """Largest (data, model) mesh from the survivors, model axis preserved.

    Model sharding cannot shrink without resharding every weight, so the
    model axis is kept and the data axis becomes
    floor(survivors / model_axis) — any remainder idles until replacement
    capacity arrives.
    """
    if surviving_devices < model_axis:
        raise RuntimeError(
            f"cannot re-mesh: {surviving_devices} survivors < model axis "
            f"{model_axis}; training must wait for replacements")
    data = surviving_devices // model_axis
    return RemeshPlan(data, model_axis,
                      surviving_devices - data * model_axis)


@dataclasses.dataclass
class ResilienceReport:
    steps_completed: int
    failures_survived: int
    restores: int
    final_step: int


def run_resilient_loop(step_fn: Callable[[int], None],
                       save_fn: Callable[[int], None],
                       restore_fn: Callable[[], int],
                       total_steps: int,
                       checkpoint_every: int = 50,
                       max_failures: int = 10) -> ResilienceReport:
    """Supervisor loop: survives step_fn raising by restoring and retrying.

    ``step_fn(step)`` runs one training step (raising on simulated/real
    failure); ``restore_fn()`` returns the step to resume from.
    """
    failures = restores = 0
    step = restore_fn()
    start = step
    while step < total_steps:
        try:
            step_fn(step)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(step)
        except Exception:  # noqa: BLE001 — any step failure triggers recovery
            failures += 1
            if failures > max_failures:
                raise
            step = restore_fn()
            restores += 1
    return ResilienceReport(step - start, failures, restores, step)
