"""Rolling-horizon cluster view: the dense ledger as a sliding window.

The paper's formulation fixes a horizon T and prices every slot of it up
front; the repo's static path (``run_pdors``) reproduces exactly that. An
*online* system has no final slot: jobs keep arriving, so the scheduler
needs a bounded lookahead that moves with the wall clock. ``RollingWindow``
provides it:

  * it owns a dense ``Cluster`` whose ``horizon`` is the lookahead width W;
    ledger index k always means absolute slot ``now + k``;
  * ``advance_to(t)`` slides the window (``Cluster.advance``): elapsed rows
    drop off the front, fresh zero rows extend the pricing horizon at the
    back — completed jobs' past commitments leave the ledger for free, and
    Q_h^r prices over the newly exposed slots start from rho = 0;
  * per-job commitments are tracked in *absolute* time so a completion,
    failure, or departure can release exactly the rows the job still holds.

Policies see the underlying ``Cluster``/``PriceTable`` objects, so the
vectorized PD-ORS machinery (snapshots, cached price matrices, min-plus DP)
runs on the window unchanged — arriving jobs are offered with a
window-relative arrival of 0.

The window shares its ``Cluster``'s ``TorchBackend``: the sliding ledger
is the same tensor on the device that the static scheduler uses,
``advance`` is a device shift, and the per-slot oversubscription guard is
a one-bool device reduce — the static path and the simulator share one
device-side ledger implementation.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.cluster import Cluster
from ..core.job import Allocation, JobSpec


class RollingWindow:
    """A ``Cluster`` ledger that slides with the simulation clock."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.now = 0
        # job_id -> {absolute slot -> Allocation}
        self.commitments: Dict[int, Dict[int, Allocation]] = {}
        self.jobs: Dict[int, JobSpec] = {}
        # absolute slot -> {job_id}: inverse of commitments, so the batched
        # engine's progress accounting walks only the jobs that actually
        # hold a row in the current slot instead of scanning every active
        # job (jobs without an allocation are exact no-ops in that scan)
        self._slot_jobs: Dict[int, set] = {}
        # job_id -> (job, alloc, need items, machines array, need matrix):
        # identity-validated demand cache for the re-grant fast path
        self._regrant_cache: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    @property
    def lookahead(self) -> int:
        return self.cluster.horizon

    def rel(self, t_abs: int) -> int:
        return t_abs - self.now

    def in_window(self, t_abs: int) -> bool:
        return 0 <= t_abs - self.now < self.lookahead

    def rel_job(self, job: JobSpec) -> JobSpec:
        """The job as the window-relative scheduler sees it: arrival at
        ledger index 0 (jobs are offered in their arrival slot, so relative
        latency equals absolute latency)."""
        return replace(job, arrival=0) if job.arrival != 0 else job

    # ------------------------------------------------------------------
    def advance_to(self, t_abs: int) -> None:
        """Slide the window so ledger index 0 == absolute slot ``t_abs``.

        Past rows roll off (their commitments have elapsed — the workload
        trained in them is already accounted), and the pricing horizon
        extends by the same number of zeroed rows."""
        steps = t_abs - self.now
        if steps < 0:
            raise ValueError(f"window cannot move backwards ({t_abs} < {self.now})")
        if steps == 0:
            return
        self.cluster.advance(steps)
        self.now = t_abs
        # prune elapsed commitments; drop jobs that no longer hold any row
        for jid in list(self.commitments):
            slots = self.commitments[jid]
            for ta in [ta for ta in slots if ta < t_abs]:
                del slots[ta]
            if not slots:
                del self.commitments[jid]
                self.jobs.pop(jid, None)
        for ta in [ta for ta in self._slot_jobs if ta < t_abs]:
            del self._slot_jobs[ta]

    # ------------------------------------------------------------------
    def commit(self, t_abs: int, job: JobSpec, alloc: Allocation) -> None:
        """Commit an allocation at an absolute slot inside the window."""
        if not self.in_window(t_abs):
            raise ValueError(
                f"slot {t_abs} outside window [{self.now}, {self.now + self.lookahead})"
            )
        if alloc.empty():
            return
        self.cluster.commit(self.rel(t_abs), job, alloc)
        slots = self.commitments.setdefault(job.job_id, {})
        prev = slots.get(t_abs)
        if prev is None:
            slots[t_abs] = Allocation(workers=dict(alloc.workers),
                                      ps=dict(alloc.ps))
        else:
            # incremental grants (e.g. several DRF bundles in one slot)
            # accumulate so release_from returns exactly what was committed
            for h, w in alloc.workers.items():
                prev.workers[h] = prev.workers.get(h, 0) + w
            for h, s in alloc.ps.items():
                prev.ps[h] = prev.ps.get(h, 0) + s
        self.jobs[job.job_id] = job
        self._slot_jobs.setdefault(t_abs, set()).add(job.job_id)

    def commit_schedule(
        self, job: JobSpec, schedule: Dict[int, Allocation]
    ) -> None:
        for t_abs in sorted(schedule):
            self.commit(t_abs, job, schedule[t_abs])

    def alloc_at(self, job_id: int, t_abs: int) -> Optional[Allocation]:
        return self.commitments.get(job_id, {}).get(t_abs)

    def holders_at(self, t_abs: int):
        """Job ids holding a committed row at ``t_abs`` (unordered)."""
        return self._slot_jobs.get(t_abs, ())

    def regrant(self, job: JobSpec, alloc: Allocation) -> bool:
        """Fused fits+commit for the slot-driven re-grant hot path.

        Equivalent (decision- and bit-identical) to
        ``cluster.fits(0, job, alloc) and (commit(now, job, alloc) or True)``
        but computes the per-machine demand vectors once per (job, alloc)
        object pair and touches only the machines the allocation uses: the
        free rows are ``capacity_matrix[hs] - used[0][hs]`` — elementwise
        the same cells ``free_matrix(0)`` would produce — and the feasible
        branch applies the exact ``ledger_add`` op ``commit`` would. Slot
        policies (FIFO/Dorm) re-grant every held allocation every slot, so
        this path dominates stream-scale wall time."""
        cl = self.cluster
        ent = self._regrant_cache.get(job.job_id)
        if ent is None or ent[0] is not job or ent[1] is not alloc:
            items = cl._alloc_need(job, alloc)
            hs = np.array([h for h, _ in items], dtype=np.intp)
            need = np.stack([n for _, n in items]) if items else \
                np.zeros((0, len(cl.resources)))
            ent = (job, alloc, items, hs, need)
            self._regrant_cache[job.job_id] = ent
        _, _, items, hs, need = ent
        # the ledger is a device tensor (on the CPU too): read the
        # version-cached host mirror, one sync per ledger version, not a
        # device slice per re-grant
        free_rows = cl.free_matrix(0)[hs]
        if (need > free_rows + 1e-9).any():
            return False
        if alloc.empty():
            return True
        # inlined cluster.commit(0, ...) reusing the cached need items
        cl.version += 1
        cl._slot_versions[0] = cl.version
        cl._used = cl.backend.ledger_add(cl._used, 0, items)
        t_abs = self.now
        slots = self.commitments.setdefault(job.job_id, {})
        prev = slots.get(t_abs)
        if prev is None:
            slots[t_abs] = Allocation(workers=dict(alloc.workers),
                                      ps=dict(alloc.ps))
        else:
            for h, w in alloc.workers.items():
                prev.workers[h] = prev.workers.get(h, 0) + w
            for h, s in alloc.ps.items():
                prev.ps[h] = prev.ps.get(h, 0) + s
        self.jobs[job.job_id] = job
        self._slot_jobs.setdefault(t_abs, set()).add(job.job_id)
        return True

    def release_from(self, job_id: int, from_abs: int) -> int:
        """Release every commitment of ``job_id`` at slots >= ``from_abs``
        (completion frees the tail it no longer needs; preemption and
        departure free everything still held). Returns slots released."""
        slots = self.commitments.get(job_id)
        if not slots:
            return 0
        job = self.jobs[job_id]
        hit = [ta for ta in slots if ta >= from_abs]
        for ta in hit:
            if self.in_window(ta):
                self.cluster.release(self.rel(ta), job, slots[ta])
            del slots[ta]
            sj = self._slot_jobs.get(ta)
            if sj is not None:
                sj.discard(job_id)
                if not sj:
                    del self._slot_jobs[ta]
        if not slots:
            self.commitments.pop(job_id, None)
            self.jobs.pop(job_id, None)
            self._regrant_cache.pop(job_id, None)
        return len(hit)

    def release_many(self, pairs: List[Tuple[int, int]]) -> Dict[int, int]:
        """Grouped ``release_from``: pairs of (job_id, from_abs), applied
        in list order under a single ledger version bump
        (``Cluster.release_group``). Returns {job_id: slots released}.
        The per-(job, slot) subtraction order is exactly the order a
        sequence of ``release_from`` calls would produce, so the ledger
        bit patterns match the per-event oracle."""
        group = []
        counts: Dict[int, int] = {}
        for job_id, from_abs in pairs:
            slots = self.commitments.get(job_id)
            if not slots:
                counts[job_id] = 0
                continue
            job = self.jobs[job_id]
            hit = [ta for ta in slots if ta >= from_abs]
            for ta in hit:
                if self.in_window(ta):
                    group.append((self.rel(ta), job, slots[ta]))
                del slots[ta]
                sj = self._slot_jobs.get(ta)
                if sj is not None:
                    sj.discard(job_id)
                    if not sj:
                        del self._slot_jobs[ta]
            if not slots:
                self.commitments.pop(job_id, None)
                self.jobs.pop(job_id, None)
                self._regrant_cache.pop(job_id, None)
            counts[job_id] = len(hit)
        self.cluster.release_group(group)
        return counts

    def jobs_on_machine(self, h: int) -> List[int]:
        """Job ids holding any committed row that touches machine ``h``,
        sorted ascending — the deterministic eviction order the engine
        walks when a MACHINE_DOWN shrinks capacity under committed rows."""
        out = []
        for jid, slots in self.commitments.items():
            for alloc in slots.values():
                if alloc.workers.get(h, 0) or alloc.ps.get(h, 0):
                    out.append(jid)
                    break
        return sorted(out)

    # ------------------------------------------------------------------
    def free_map(self, k: int = 0) -> Dict[Tuple[int, str], float]:
        """Free capacity at window-relative slot ``k`` (default: the
        current slot) as the {(h, r): amount} map the round-robin
        placement helper mutates."""
        fm = self.cluster.free_matrix(k)
        return {
            (h, r): float(fm[h, ri])
            for h in range(self.cluster.num_machines)
            for ri, r in enumerate(self.cluster.resources)
        }

    def utilization_now(self) -> Dict[str, float]:
        return self.cluster.utilization(0)

    def oversubscribed(self, tol: float = 1e-6) -> bool:
        """True if any ledger cell exceeds capacity (accounting bug guard;
        delegates to the cluster's array backend — a one-bool device sync
        per checked slot)."""
        return self.cluster.oversubscribed(tol)
