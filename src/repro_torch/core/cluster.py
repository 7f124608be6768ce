"""Cluster model: machines, capacities, and the allocation ledger (Eq. 5).

Dense ledger memory model
-------------------------
The ledger rho_h^r[t] is a single preallocated ``(T, H, R)`` float64 ndarray
(``_used``) with a fixed resource axis (``resources`` sorted once, indexed by
``res_index``). Capacities live in a ``(H, R)`` matrix. Every hot query is a
slice — ``free_matrix(t)`` is one vectorized subtraction, ``commit``/
``release`` add/subtract a per-machine demand vector, and ``utilization`` is
a pair of axis reductions. Scalar accessors (``used``/``free``/``capacity``)
are kept for tests and cold paths and read single ndarray cells.

Per-job demand vectors (alpha_i^r / beta_i^r laid out on the cluster's
resource axis) are memoized per job object, so the per-slot ledger update of
Algorithm 1 step 3 costs O(R) flops instead of O(R) dict lookups per machine.

``release`` clamps at zero: a double-release would otherwise silently drive
ledger entries negative and corrupt ``free()`` and therefore the prices
Q_h^r. It does not assert on the clamp: that would force a device sync
per release.

Device ledger
-------------
The ledger array and its derived tensors are owned by a
``repro_torch.backend.TorchBackend`` (``backend`` field: instance, or
None = a backend on the CUDA card, which raises when there is none).
``_used`` is a float64 tensor on the backend's device, updated in place;
host reads go through version-cached host mirrors (``free_matrix``,
``used_matrix``) so a whole repricing epoch costs one device->host sync.
``device_free_tensor`` exposes the on-device (T, H, R) free tensor for the
snapshot reduction kernel.

Two presets are provided:
  * ``ethernet`` — the paper's own experimental setting (EC2 C5n-like):
    resources {gpu, cpu, mem, storage}, capacities ~18x a worker's demand.
  * ``tpu`` — the TPU adaptation (DESIGN.md §3): resources
    {chips, hbm, host_cpu, host_mem}; a "machine" is a pod slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..backend import ArrayBackend, get_backend
from .job import JobSpec, Allocation, Resource


@dataclass(frozen=True)
class Machine:
    machine_id: int
    capacity: Dict[Resource, float]  # C_h^r


@dataclass
class Cluster:
    machines: List[Machine]
    horizon: int  # T
    # array backend owning the ledger: instance, or None = a TorchBackend
    # on the CUDA card
    backend: Optional[ArrayBackend] = None

    def __post_init__(self) -> None:
        self.backend = get_backend(self.backend)
        self.resources: List[Resource] = sorted(
            {r for m in self.machines for r in m.capacity}
        )
        self.res_index: Dict[Resource, int] = {
            r: k for k, r in enumerate(self.resources)
        }
        H, R = len(self.machines), len(self.resources)
        self.capacity_matrix = np.zeros((H, R))  # C_h^r
        for h, m in enumerate(self.machines):
            for r, c in m.capacity.items():
                self.capacity_matrix[h, self.res_index[r]] = c
        # fault-domain capacity mask (repro.sim.faults): nominal capacities
        # are kept in _base_capacity; a mask entry < 1 models a degraded
        # machine (0 = crashed) and scales every derived tensor — free,
        # prices, fits — through capacity_matrix. None means no mask has
        # ever been applied and capacity_matrix IS _base_capacity (same
        # object), so clean runs keep the exact pre-mask bit patterns.
        self._base_capacity = self.capacity_matrix
        self._capacity_mask: Optional[np.ndarray] = None
        # rho_h^r[t]: the dense allocation ledger (a tensor on the device)
        self._used = self.backend.zeros((self.horizon, H, R))
        # bumped on every commit/release; lets PriceTable & snapshots cache
        # per-slot derived matrices between ledger mutations
        self.version = 0
        # per-slot version stamps: _slot_versions[t] is the ledger version
        # of the last mutation that could have changed row t's derived
        # tensors (commit/release on t, a capacity-mask change, or the row
        # sliding in on advance). A slot whose stamp is unchanged since a
        # SolvePlan was built has bit-identical free/price content, which
        # is what plan patching and warm bundle reuse key on.
        self._slot_versions = np.zeros(self.horizon, dtype=np.int64)
        # counts advance() calls: plan patching is only valid while the
        # window has not slid (relative slot indices keep their meaning)
        self.advances = 0
        # job -> (alpha vec, beta vec) on the cluster's resource axis
        self._demand_cache: Dict[int, Tuple[JobSpec, np.ndarray, np.ndarray]] = {}
        # t -> (version, C - rho[t]) cache for free_matrix
        self._free_cache: Dict[int, Tuple[int, np.ndarray]] = {}
        # (version, device (T,H,R) C - rho) and the host mirrors of
        # free/used — ONE sync per ledger version covers every slot
        self._free_dev: Optional[Tuple[int, object]] = None
        self._free_host: Optional[Tuple[int, np.ndarray]] = None
        self._used_host: Optional[Tuple[int, np.ndarray]] = None

    # ------------------------------------------------------------------
    @property
    def num_machines(self) -> int:
        return len(self.machines)

    def capacity(self, h: int, r: Resource) -> float:
        k = self.res_index.get(r)
        return float(self.capacity_matrix[h, k]) if k is not None else 0.0

    def used(self, t: int, h: int, r: Resource) -> float:
        k = self.res_index.get(r)
        if k is None or not (0 <= t < self.horizon):
            return 0.0
        # via the version-cached host mirror: scalar reads must not cost a
        # device sync each
        return float(self.used_matrix(t)[h, k])

    def free(self, t: int, h: int, r: Resource) -> float:
        return self.capacity(h, r) - self.used(t, h, r)

    def used_matrix(self, t: int) -> np.ndarray:
        """rho[t] as a host (H, R) array: a slice of the version-cached
        host mirror, so repeated reads cost one sync per ledger version
        (do not mutate)."""
        ent = self._used_host
        if ent is None or ent[0] != self.version:
            ent = (self.version, self.backend.to_host(self._used))
            self._used_host = ent
        return ent[1][t]

    def device_free_tensor(self):
        """C - rho as the backend's (T, H, R) array, version-cached.
        Stays on the device (no host sync) — the operand the snapshot
        reduction kernel reads per (job, plan)."""
        ent = self._free_dev
        if ent is None or ent[0] != self.version:
            ent = (self.version,
                   self.backend.free_tensor(self._used, self.capacity_matrix))
            self._free_dev = ent
        return ent[1]

    def _free_tensor_host(self) -> np.ndarray:
        """Host mirror of ``device_free_tensor`` — the one device->host
        sync per ledger version that serves every slot's free_matrix."""
        ent = self._free_host
        if ent is None or ent[0] != self.version:
            ent = (self.version, self.backend.to_host(self.device_free_tensor()))
            self._free_host = ent
        return ent[1]

    def free_matrix(self, t: int) -> np.ndarray:
        """C - rho[t] as a host (H, R) array, cached until the next ledger
        mutation (callers must not write into it)."""
        ent = self._free_cache.get(t)
        if ent is None or ent[0] != self.version:
            ent = (self.version, self._free_tensor_host()[t])
            self._free_cache[t] = ent
        return ent[1]

    def total_capacity(self) -> float:
        """sum_h sum_r C_h^r (used by mu in pricing, Eq. 14)."""
        return float(sum(sum(m.capacity.values()) for m in self.machines))

    # ------------------------------------------------- fault-domain mask
    @property
    def capacity_mask(self) -> np.ndarray:
        """Effective per-machine capacity factors (H,): 1 everywhere when
        no fault is active, 0 for a crashed machine, in (0, 1) for a
        straggler."""
        if self._capacity_mask is None:
            return np.ones(self.num_machines)
        return self._capacity_mask.copy()

    def set_capacity_mask(self, mask) -> None:
        """Install per-machine capacity factors (repro.sim fault domains).

        ``capacity_matrix`` becomes ``_base_capacity * mask[:, None]``, so
        every derived tensor — free, prices (a zeroed row prices at the U^r
        ceiling), ``fits`` — sees the degraded machine without any backend
        change. ``version`` bumps on every effective change so free/price
        caches and ``SolvePlan.fresh()`` invalidate. Restoring the all-ones
        mask reinstates the *original* capacity array object: clean-trace
        bit patterns are untouched, and a faulted cluster recovers
        bit-identically."""
        mask = np.asarray(mask, dtype=float)
        if mask.shape != (self.num_machines,):
            raise ValueError(
                f"capacity mask shape {mask.shape} != ({self.num_machines},)"
            )
        if np.any(mask < 0.0) or np.any(mask > 1.0):
            raise ValueError("capacity mask factors must lie in [0, 1]")
        clean = bool(np.all(mask == 1.0))
        if self._capacity_mask is None and clean:
            return  # no-op: never masked, nothing to restore
        if (self._capacity_mask is not None
                and np.array_equal(mask, self._capacity_mask)):
            return  # unchanged: don't invalidate caches for nothing
        self.version += 1
        # every slot's free/price tensors derive from capacity_matrix
        self._slot_versions[:] = self.version
        if clean:
            self._capacity_mask = None
            self.capacity_matrix = self._base_capacity
        else:
            self._capacity_mask = mask.copy()
            self.capacity_matrix = self._base_capacity * mask[:, None]

    def machine_overcommitted(self, h: int, tol: float = 1e-6) -> bool:
        """True if any in-horizon ledger row on machine ``h`` exceeds its
        current (possibly masked) capacity — the eviction-cascade driver
        after a MACHINE_DOWN shrinks ``capacity_matrix`` under committed
        rows. Cold path: one host read of the machine's (T, R) ledger
        column per call."""
        used = self.backend.to_host(self._used)[:, h, :]
        return bool(np.any(used > self.capacity_matrix[h][None, :] + tol))

    # ------------------------------------------------------------------
    def demand_vectors(self, job: JobSpec) -> Tuple[np.ndarray, np.ndarray]:
        """(alpha_i, beta_i) as (R,) vectors on this cluster's resource axis.

        Memoized per job object (keyed by job_id, validated by identity so a
        different JobSpec reusing an id recomputes)."""
        ent = self._demand_cache.get(job.job_id)
        if ent is None or ent[0] is not job:
            wd = np.array(
                [job.worker_demand.get(r, 0.0) for r in self.resources]
            )
            sd = np.array([job.ps_demand.get(r, 0.0) for r in self.resources])
            ent = (job, wd, sd)
            self._demand_cache[job.job_id] = ent
        return ent[1], ent[2]

    def _alloc_need(
        self, job: JobSpec, alloc: Allocation
    ) -> List[Tuple[int, np.ndarray]]:
        """[(h, need vector)] for every machine the allocation touches."""
        wd, sd = self.demand_vectors(job)
        out = []
        for h in set(alloc.workers) | set(alloc.ps):
            w = alloc.workers.get(h, 0)
            s = alloc.ps.get(h, 0)
            out.append((h, wd * w + sd * s))
        return out

    def fits(self, t: int, job: JobSpec, alloc: Allocation) -> bool:
        """Capacity check for one slot (Eq. 5)."""
        if 0 <= t < self.horizon:
            # the version-cached host mirror of C - rho[t]
            free = self.free_matrix(t)
        else:
            free = self.capacity_matrix
        for h, need in self._alloc_need(job, alloc):
            if np.any(need > free[h] + 1e-9):
                return False
        return True

    def slot_version(self, t: int) -> int:
        """Version stamp of the last mutation affecting slot ``t``'s
        derived tensors (0 = untouched since construction). Out-of-horizon
        slots return -1 so they never compare equal to a recorded stamp."""
        if not (0 <= t < self.horizon):
            return -1
        return int(self._slot_versions[t])

    def commit(self, t: int, job: JobSpec, alloc: Allocation) -> None:
        """rho update of Algorithm 1 step 3."""
        if not (0 <= t < self.horizon):
            return
        self.version += 1
        self._slot_versions[t] = self.version
        self._used = self.backend.ledger_add(
            self._used, t, self._alloc_need(job, alloc)
        )

    def release(self, t: int, job: JobSpec, alloc: Allocation) -> None:
        """Inverse of commit, clamped at zero (a double-release must not
        drive the ledger negative — that would understate rho and corrupt
        prices)."""
        if not (0 <= t < self.horizon):
            return
        self.version += 1
        self._slot_versions[t] = self.version
        self._used = self.backend.ledger_sub_clamped(
            self._used, t, self._alloc_need(job, alloc)
        )

    def release_group(self, items: List[Tuple[int, JobSpec, Allocation]]) -> None:
        """Release a batch of (slot, job, alloc) grants under one version
        bump. The per-item ledger subtractions run in list order through
        the exact same backend op as ``release``, so the resulting ledger
        bit patterns equal a sequence of individual releases — only the
        number of version bumps differs, which every derived-tensor cache
        is indifferent to (they compare stamps for equality, not deltas).
        The batched sim engine uses this to fold a slot's completion and
        failure cascades into one grouped release."""
        live = [(t, job, alloc) for t, job, alloc in items
                if 0 <= t < self.horizon]
        if not live:
            return
        self.version += 1
        for t, job, alloc in live:
            self._slot_versions[t] = self.version
            self._used = self.backend.ledger_sub_clamped(
                self._used, t, self._alloc_need(job, alloc)
            )

    def advance(self, steps: int = 1) -> None:
        """Slide the ledger left by ``steps`` slots (rolling-horizon mode).

        Row 0 — the slot that just elapsed — drops off the front and a zero
        row appears at the back, so index k afterwards refers to the slot
        that was index k+steps before. The static PD-ORS path never calls
        this; ``repro.sim`` advances the window as wall-clock slots elapse.
        All derived caches invalidate via the version bump."""
        if steps <= 0:
            return
        self.version += 1
        self.advances += 1
        # stamps slide with their row content: index k now refers to the
        # slot that was k+steps, so a warm-store entry keyed by absolute
        # slot + stamp stays valid across the slide. Fresh back rows are
        # stamped with the current version (their zero content is new).
        k = min(steps, self.horizon)
        if k < self.horizon:
            self._slot_versions[:-k] = self._slot_versions[k:]
        self._slot_versions[self.horizon - k:] = self.version
        self._used = self.backend.ledger_advance(self._used, steps)

    def oversubscribed(self, tol: float = 1e-6) -> bool:
        """True if any ledger cell exceeds capacity (accounting bug guard;
        a one-bool device sync)."""
        return self.backend.oversubscribed(
            self._used, self.capacity_matrix, tol
        )

    def utilization(self, t: int) -> Dict[Resource, float]:
        cap = self.capacity_matrix.sum(axis=0)          # (R,)
        use = self.used_matrix(t).sum(axis=0) if 0 <= t < self.horizon else \
            np.zeros_like(cap)
        return {
            r: float(use[k] / cap[k]) if cap[k] else 0.0
            for r, k in self.res_index.items()
        }


# ----------------------------------------------------------------------
def make_cluster(
    num_machines: int,
    horizon: int,
    preset: str = "ethernet",
    capacity_scale: float = 1.0,
    device=None,
) -> Cluster:
    """A cluster of identical machines whose ledger lives on ``device``
    (None = the CUDA card; raises when there is none)."""
    if preset == "ethernet":
        # paper §5: capacity ≈ 18x a worker/PS demand (EC2 C5n.18xlarge-like)
        cap = {
            "gpu": 72.0 * capacity_scale,      # 18 x up-to-4 GPUs
            "cpu": 180.0 * capacity_scale,     # 18 x up-to-10 vCPU
            "mem": 576.0 * capacity_scale,     # 18 x up-to-32 GB
            "storage": 180.0 * capacity_scale, # 18 x up-to-10 GB
        }
    elif preset == "tpu":
        # a "machine" = one v5e pod slice of 16 chips (DESIGN.md §3)
        cap = {
            "chips": 16.0 * capacity_scale,
            "hbm": 16.0 * 16.0 * capacity_scale,   # GB
            "host_cpu": 224.0 * capacity_scale,
            "host_mem": 512.0 * capacity_scale,
        }
    else:
        raise ValueError(f"unknown preset {preset!r}")
    machines = [Machine(h, dict(cap)) for h in range(num_machines)]
    return Cluster(machines=machines, horizon=horizon,
                   backend=get_backend(None, device))
