"""Fault tolerance & straggler mitigation for the join runtime — a copy
of the JAX package's ``distributed.fault`` for the port (host code; the
plans it regroups hold torch tensors).

MapReduce's resilience model — deterministic, idempotent tasks re-executed
on failure — is the paper's implicit substrate (§2.2 JobTracker). Ported
here explicitly:

* ``GroupExecutor`` runs join groups as independent work units with
  bounded retries; a group's output depends only on (plan, group id), so
  re-execution is always safe.
* Speculative execution: after ``speculate_after`` fraction of groups
  finish, still-running groups are re-issued (first finisher wins) —
  Hadoop's backup tasks. On a real pod the backup lands on an idle device;
  here both run on host, and the *scheduling logic* is what's under test.
* ``regroup`` regroups partitions when the device count changes:
  scale-down merges groups (θ/LB stay valid — Thm 6 min over a superset is
  still a lower bound); scale-up splits the most-loaded groups (bounds
  recomputed per new group: cheap host work on T_R/T_S).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.api import JoinPlan
from ..core.bounds import group_lower_bounds

__all__ = ["GroupExecutor", "GroupRun", "grow_groups", "regroup",
           "shrink_groups"]


@dataclasses.dataclass
class GroupRun:
    group: int
    attempts: int = 0
    done: bool = False
    result: Any = None
    seconds: float = 0.0
    speculated: bool = False


class GroupExecutor:
    """Run per-group work with retries + speculative re-issue."""

    def __init__(self, max_retries: int = 2, speculate: bool = True,
                 speculate_after: float = 0.75, max_workers: int = 4,
                 attempt_timeout: Optional[float] = None):
        self.max_retries = max_retries
        self.speculate = speculate
        self.speculate_after = speculate_after
        self.max_workers = max_workers
        # per-attempt wall-clock budget (seconds): an attempt that
        # exceeds it counts as a failure and is re-issued like any other
        # — a hung group_fn can no longer stall the pool forever. None
        # keeps the old block-until-done behavior.
        self.attempt_timeout = attempt_timeout

    def run(self, group_fn: Callable[[int], Any], groups: List[int],
            ) -> Dict[int, GroupRun]:
        runs = {g: GroupRun(group=g) for g in groups}

        def attempt(g):
            t0 = time.monotonic()
            out = group_fn(g)
            return g, out, time.monotonic() - t0

        def fail(g, r, cause):
            counts = {gg: rr.attempts for gg, rr in runs.items()}
            raise RuntimeError(
                f"group {g} failed after {r.attempts} attempts "
                f"(per-group attempt counts: {counts})") from cause

        pool = ThreadPoolExecutor(max_workers=self.max_workers)
        try:
            fut_group = {pool.submit(attempt, g): g for g in groups}
            expiry = ({f: time.monotonic() + self.attempt_timeout
                       for f in fut_group}
                      if self.attempt_timeout is not None else {})
            pending = set(fut_group)

            def reissue(g):
                nf = pool.submit(attempt, g)
                fut_group[nf] = g
                if self.attempt_timeout is not None:
                    expiry[nf] = time.monotonic() + self.attempt_timeout
                pending.add(nf)

            speculated = False
            while pending:
                if all(r.done for r in runs.values()):
                    break   # stragglers' twins won; don't wait for losers
                budget = None
                if self.attempt_timeout is not None:
                    budget = max(0.0, min(expiry[f] for f in pending)
                                 - time.monotonic())
                done, pending = wait(pending, timeout=budget,
                                     return_when=FIRST_COMPLETED)
                for fut in done:
                    g = fut_group[fut]
                    r = runs[g]
                    r.attempts += 1
                    if fut.exception() is not None:
                        if r.done:
                            continue  # a speculative twin already finished
                        if r.attempts > self.max_retries:
                            fail(g, r, fut.exception())
                        reissue(g)
                        continue
                    _, out, secs = fut.result()
                    if not r.done:
                        r.done, r.result, r.seconds = True, out, secs
                # timed-out attempts count as failures and are re-issued;
                # the stuck thread is orphaned (threads can't be killed)
                # and its eventual result, if any, is ignored
                if self.attempt_timeout is not None:
                    now = time.monotonic()
                    for fut in [f for f in pending if expiry[f] <= now]:
                        pending.discard(fut)
                        g = fut_group[fut]
                        r = runs[g]
                        if r.done:
                            continue
                        r.attempts += 1
                        if r.attempts > self.max_retries:
                            fail(g, r, TimeoutError(
                                f"group {g} attempt exceeded "
                                f"{self.attempt_timeout}s"))
                        reissue(g)
                n_done = sum(r.done for r in runs.values())
                if (self.speculate and not speculated
                        and n_done >= self.speculate_after * len(groups)
                        and n_done < len(groups)):
                    speculated = True
                    for g, r in runs.items():
                        if not r.done:
                            r.speculated = True
                            reissue(g)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        return runs

    def run_with_retries(self, group_fn: Callable[[int], Any],
                         groups: List[int]) -> Dict[int, GroupRun]:
        """Retry loop around `run` for fault injection tests."""
        runs: Dict[int, GroupRun] = {g: GroupRun(group=g) for g in groups}
        remaining = list(groups)
        for attempt_no in range(self.max_retries + 1):
            failed = []
            for g in remaining:
                runs[g].attempts += 1
                try:
                    t0 = time.monotonic()
                    runs[g].result = group_fn(g)
                    runs[g].seconds = time.monotonic() - t0
                    runs[g].done = True
                except Exception:
                    failed.append(g)
            remaining = failed
            if not remaining:
                break
        if remaining:
            raise RuntimeError(
                f"groups {remaining} failed after {self.max_retries + 1} attempts")
        return runs


# ----------------------------------------------------------- elasticity
def _query(plan):
    return plan.query if isinstance(plan, JoinPlan) else plan


def _with_grouping(plan, groups: np.ndarray, n_groups: int):
    """Replace the grouping on a composite ``JoinPlan`` (regroup its
    per-batch ``QueryPlan``; the S index is untouched — elasticity never
    re-runs S-side phase 1) or on a bare ``QueryPlan``: the groups and
    their Thm-6 lower bounds, on the plan's device."""
    q = _query(plan)
    g = torch.as_tensor(groups.astype(np.int32), device=q.lb.device)
    lb_group = group_lower_bounds(q.lb, g, n_groups)
    q = dataclasses.replace(q, groups=g, lb_group=lb_group)
    if isinstance(plan, JoinPlan):
        return dataclasses.replace(plan, query=q)
    return q


def shrink_groups(plan, new_n: int):
    """Merge groups for a smaller device count (θ, LB stay valid)."""
    q = _query(plan)
    old_n = q.n_groups
    assert new_n < old_n
    mapping = np.arange(old_n) % new_n
    groups = mapping[q.groups.cpu().numpy()]
    return _with_grouping(plan, groups, new_n)


def grow_groups(plan, new_n: int):
    """Split the most-populated groups for a larger device count."""
    q = _query(plan)
    old_n = q.n_groups
    assert new_n > old_n
    groups = q.groups.cpu().numpy().astype(np.int64)
    counts = q.t_r.counts.cpu().numpy().astype(np.int64)
    next_id = old_n
    while next_id < new_n:
        load = np.zeros(next_id, np.int64)
        np.add.at(load, groups, counts)
        heavy = int(np.argmax(load))
        members = np.where(groups == heavy)[0]
        if members.size <= 1:
            break  # cannot split single-partition groups further
        # move the later half of its partitions (by pivot order) out
        movers = members[members.size // 2:]
        groups[movers] = next_id
        next_id += 1
    return _with_grouping(plan, groups, next_id)


def regroup(plan, new_n: int):
    """``plan`` regrouped onto ``new_n`` groups (a ``JoinPlan`` or a
    ``QueryPlan``; returned as the same kind)."""
    n = _query(plan).n_groups
    if new_n == n:
        return plan
    return shrink_groups(plan, new_n) if new_n < n \
        else grow_groups(plan, new_n)
