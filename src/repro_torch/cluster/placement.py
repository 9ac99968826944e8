"""Hardware-aware trial placement (DESIGN.md §11).

SHADHO-style scheduling: instead of a fixed ``devices_per_trial``, the cluster
executor asks a placement policy where each trial should run and how wide its
slice should be, given what is known about the trial's workload (its roofline
profile) and each host's hardware (``HostSpec`` throughputs).

The cost model is the same three-term roofline as ``launch/roofline.py``:

    step_s(n) = max( flops / (n * peak_flops),        # compute, ideal scaling
                     bytes / (n * hbm_bw),            # HBM traffic, sharded
                     coll_bytes * (n-1)/n / link_bw ) # ring all-reduce traffic

Compute and memory shrink with slice width; collective traffic *grows* toward
the ring asymptote — which is exactly why "as wide as fits" is the wrong
default and right-sizing is a real decision.

Workload costs come from, in priority order:
  1. ``trial.config["_cost"]``: explicit {"flops", "bytes", "coll_bytes"}.
  2. ``trial.profile``: the PR 7 hardware profile that rides the result
     stream — its ``roofline_*_s`` seconds are denormalized back to work
     units via the reference hardware constants below.
  3. Nothing known: fall back to the fixed default width.

This module imports no model code (the cluster controller may run where no
card is); the reference constants are the H100 SXM's, written out.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .hosts import HostAgent, HostSpec

__all__ = ["FixedPlacement", "RooflinePlacement", "estimate_step_s",
           "workload_cost"]

# The H100 SXM's figures (per card): the units the port's trial profiles are
# written in.  Kept literal so importing placement loads no model code.
REF_PEAK_FLOPS_BF16 = 989e12
REF_HBM_BW = 3.35e12
REF_ICI_BW = 450e9


def workload_cost(trial: Any) -> Optional[Dict[str, float]]:
    """Extract {"flops", "bytes", "coll_bytes"} work units for one step of
    ``trial``, or None when nothing is known yet (first placement of an
    unprofiled trial)."""
    cost = trial.config.get("_cost") if isinstance(trial.config, dict) else None
    if isinstance(cost, dict) and "flops" in cost:
        return {"flops": float(cost.get("flops", 0.0)),
                "bytes": float(cost.get("bytes", 0.0)),
                "coll_bytes": float(cost.get("coll_bytes", 0.0))}
    prof = getattr(trial, "profile", None)
    if isinstance(prof, dict) and "roofline_compute_s" in prof:
        return {
            "flops": float(prof["roofline_compute_s"]) * REF_PEAK_FLOPS_BF16,
            "bytes": float(prof.get("roofline_memory_s", 0.0)) * REF_HBM_BW,
            "coll_bytes":
                float(prof.get("roofline_collective_s", 0.0)) * REF_ICI_BW,
        }
    return None


def estimate_step_s(cost: Dict[str, float], spec: HostSpec, n: int) -> float:
    """Roofline step-time estimate for this workload on ``n`` devices of
    ``spec``.  ``n >= 1``."""
    n = max(1, int(n))
    compute_s = cost["flops"] / (n * spec.peak_flops)
    memory_s = cost["bytes"] / (n * spec.hbm_bw)
    collective_s = (cost["coll_bytes"] * (n - 1) / n) / spec.link_bw
    return max(compute_s, memory_s, collective_s)


def _widths_upto(cap: int) -> List[int]:
    """Candidate slice widths: powers of two up to ``cap`` (matching how
    sub-meshes shard cleanly), plus ``cap`` itself."""
    out = []
    w = 1
    while w <= cap:
        out.append(w)
        w *= 2
    if out and out[-1] != cap:
        out.append(cap)
    return out


class FixedPlacement:
    """The pre-cluster behavior, host-aware: every trial gets its requested
    width on the host with the most free devices (roster order breaks ties —
    deterministic under VirtualClock)."""

    def __init__(self, devices_per_trial: Optional[int] = None):
        self.devices_per_trial = devices_per_trial

    def place(self, trial: Any, hosts: Sequence[HostAgent]
              ) -> Optional[Tuple[HostAgent, int]]:
        want = self.devices_per_trial or trial.resources.devices
        best = None
        for host in hosts:
            if not host.alive or not host.pool.can_fit(want):
                continue
            if best is None or host.pool.n_free > best.pool.n_free:
                best = host
        return (best, want) if best is not None else None


class RooflinePlacement:
    """Right-size each trial's slice per host with the roofline cost model.

    For every alive host, every candidate width that currently fits is scored
    by ``estimate_step_s``; the (host, width) with the lowest predicted step
    time wins, preferring the *narrowest* width within ``tolerance`` of the
    best — devices freed by not over-widening one trial run other trials.
    Unprofiled trials fall back to FixedPlacement semantics until their first
    profile arrives (profiles ride the result stream, so a restart or resize
    after warmup places better than the first launch).
    """

    def __init__(self, devices_per_trial: Optional[int] = None,
                 max_devices: int = 64, tolerance: float = 0.05):
        self.fallback = FixedPlacement(devices_per_trial)
        self.max_devices = int(max_devices)
        self.tolerance = float(tolerance)

    def place(self, trial: Any, hosts: Sequence[HostAgent]
              ) -> Optional[Tuple[HostAgent, int]]:
        cost = workload_cost(trial)
        if cost is None:
            return self.fallback.place(trial, hosts)
        best: Optional[Tuple[HostAgent, int]] = None
        best_s = float("inf")
        for host in hosts:
            if not host.alive:
                continue
            cap = min(host.pool.largest_free_block(), self.max_devices)
            if cap < 1:
                continue
            for n in _widths_upto(cap):
                s = estimate_step_s(cost, host.spec, n)
                # strictly-better, or same-within-tolerance but narrower
                if (s < best_s * (1.0 - self.tolerance)
                        or (best is not None
                            and s <= best_s * (1.0 + self.tolerance)
                            and n < best[1])):
                    best, best_s = (host, n), min(s, best_s)
        return best
