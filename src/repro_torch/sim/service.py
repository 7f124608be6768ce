"""Async offer service: an asyncio front-end over ``PDORS.offer_batch``.

The simulator drives the scheduler in-process; this module is the
service-shaped boundary around the same core — the shape a cluster
deployment would speak (cf. the long-poll FIFO scheduler services this
repo's related work grew out of): workers register and heartbeat, jobs
are submitted concurrently and admitted in *batches*, grants are
delivered through a long-poll queue, and ``/metrics`` renders the
process-wide ``repro_torch.obs.metrics`` registry.

Determinism contract: every submission window is collected into one
batch, sorted by ``job_id``, and offered through the exact
``PDORS.offer_batch`` path the static scheduler uses — so a set of
concurrent submissions produces byte-identical admissions/schedules to a
single ``offer_batch`` call over the same jobs
(``tests/test_torch_service.py``). The service adds no scheduling logic
of its own; it only shapes concurrency around the core.

No third-party server framework is used (the container image carries
none): the optional HTTP front-end (``start_http``) is a minimal
``asyncio.start_server`` loop speaking just enough HTTP/1.1 for
``/register``, ``/heartbeat``, ``/workers`` and ``/metrics``. Offer
submission stays on the Python API — ``JobSpec`` round-tripping belongs
to the simulator, not a wire format.

SLO accounting: per-offer admission latency (submit -> decision) feeds
streaming P-squared p50/p99 estimators (``sim.metrics.P2Quantile``) and
is published as gauges in the registry; ``repro_torch.launch.sim
--service`` prints the same columns for the service-latency row.

On a CUDA ledger each offer syncs the stream, and ``_process`` runs
``offer_batch`` on the loop's own thread (the kernels' staging buffers
are per thread), so how submissions group into batches depends on how
long each batch takes.
"""
from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from ..core.job import JobSpec
from ..core.pdors import PDORS, AdmissionRecord
from ..obs.metrics import get_registry
from .metrics import P2Quantile

_CLOSE = object()          # inbox sentinel: flush and stop the batch loop


@dataclass
class _Submission:
    job: JobSpec
    future: "asyncio.Future[AdmissionRecord]"
    enqueued: float


@dataclass
class WorkerInfo:
    worker_id: str
    cores: int
    last_seen: float


class OfferService:
    """Admission-batching offer service over one ``PDORS`` scheduler.

    Lifecycle: ``await start()`` -> ``submit``/``poll``/``heartbeat``
    concurrently -> ``await close()`` (graceful: the pending batch is
    flushed and already-granted offers stay pollable — nothing is
    dropped).

    ``clock`` is the registry/eviction clock (monotonic seconds) and is
    injectable so tests drive heartbeat expiry without sleeping;
    ``timer`` is the latency clock (``perf_counter``)."""

    def __init__(
        self,
        scheduler: PDORS,
        batch_window: float = 0.002,
        heartbeat_timeout: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        timer: Callable[[], float] = time.perf_counter,
    ):
        self.scheduler = scheduler
        self.batch_window = batch_window
        self.heartbeat_timeout = heartbeat_timeout
        self.clock = clock
        self.timer = timer
        self.workers: Dict[str, WorkerInfo] = {}
        self._inbox: "asyncio.Queue" = asyncio.Queue()
        self._grants: Deque[dict] = deque()
        self._grants_cv: Optional[asyncio.Condition] = None
        self._flush_ev: Optional[asyncio.Event] = None
        self._batcher: Optional[asyncio.Task] = None
        self._reaper: Optional[asyncio.Task] = None
        self._closing = False
        self._closed = False
        # SLO accounting (streaming; see module docstring)
        self._lat_p50 = P2Quantile(0.50)
        self._lat_p99 = P2Quantile(0.99)
        self._lat_n = 0
        self._lat_sum = 0.0
        self.offers_total = 0
        self.admitted_total = 0
        self.batches_total = 0
        self.evictions_total = 0

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> "OfferService":
        self._grants_cv = asyncio.Condition()
        self._flush_ev = asyncio.Event()
        self._batcher = asyncio.create_task(self._batch_loop())
        if self.heartbeat_timeout > 0:
            self._reaper = asyncio.create_task(self._reap_loop())
        return self

    async def close(self) -> None:
        """Graceful shutdown: flush every queued submission through one
        final batch, resolve all futures, wake every long-poller. Grants
        already queued remain pollable after close."""
        if self._closed:
            return
        self._closing = True
        self._flush_ev.set()        # cut any open batch window short
        await self._inbox.put(_CLOSE)
        if self._batcher is not None:
            await self._batcher
        if self._reaper is not None:
            self._reaper.cancel()
            try:
                await self._reaper
            except asyncio.CancelledError:
                pass
        self._closed = True
        async with self._grants_cv:
            self._grants_cv.notify_all()

    # -- worker registry ------------------------------------------------
    def register(self, worker_id: str, cores: int = 1) -> dict:
        self.workers[worker_id] = WorkerInfo(worker_id, int(cores),
                                             self.clock())
        return {"ok": True, "worker_id": worker_id}

    def heartbeat(self, worker_id: str) -> bool:
        info = self.workers.get(worker_id)
        if info is None:
            return False
        info.last_seen = self.clock()
        return True

    def evict_expired(self) -> List[str]:
        """Drop workers whose heartbeat lapsed past the timeout."""
        now = self.clock()
        dead = [wid for wid, info in self.workers.items()
                if now - info.last_seen > self.heartbeat_timeout]
        for wid in dead:
            del self.workers[wid]
        self.evictions_total += len(dead)
        return dead

    def alive_workers(self) -> List[WorkerInfo]:
        now = self.clock()
        return sorted(
            (i for i in self.workers.values()
             if now - i.last_seen <= self.heartbeat_timeout),
            key=lambda i: i.worker_id,
        )

    def workers_snapshot(self) -> dict:
        alive = self.alive_workers()
        return {
            "worker_count": len(alive),
            "total_slots": sum(i.cores for i in alive),
            "workers": [{"worker_id": i.worker_id, "cores": i.cores}
                        for i in alive],
        }

    async def _reap_loop(self) -> None:
        period = max(self.heartbeat_timeout / 4.0, 0.01)
        while True:
            await asyncio.sleep(period)
            self.evict_expired()

    # -- offers ---------------------------------------------------------
    async def submit(self, job: JobSpec) -> AdmissionRecord:
        """Submit one job; resolves with its admission record after the
        batch it lands in is offered."""
        if self._closing:
            raise RuntimeError("OfferService is closed")
        fut: "asyncio.Future[AdmissionRecord]" = (
            asyncio.get_running_loop().create_future())
        await self._inbox.put(_Submission(job, fut, self.timer()))
        return await fut

    async def _batch_loop(self) -> None:
        while True:
            item = await self._inbox.get()
            closing = item is _CLOSE
            batch: List[_Submission] = [] if closing else [item]
            if not closing and self.batch_window > 0:
                # admission batching: let concurrent submitters land in
                # the same batch before offering (close() cuts the
                # window short via the flush event)
                try:
                    await asyncio.wait_for(self._flush_ev.wait(),
                                           self.batch_window)
                except asyncio.TimeoutError:
                    pass
            while not self._inbox.empty():
                nxt = self._inbox.get_nowait()
                if nxt is _CLOSE:
                    closing = True
                else:
                    batch.append(nxt)
            if batch:
                await self._process(batch)
            if closing:
                return

    async def _process(self, batch: List[_Submission]) -> None:
        # deterministic batch order: PDORS admissions reprice the ledger
        # mid-batch, so the offer order must not depend on arrival races
        batch.sort(key=lambda s: s.job.job_id)
        records = self.scheduler.offer_batch([s.job for s in batch])
        done = self.timer()
        self.batches_total += 1
        async with self._grants_cv:
            for sub, rec in zip(batch, records):
                lat = done - sub.enqueued
                self._lat_p50.observe(lat)
                self._lat_p99.observe(lat)
                self._lat_n += 1
                self._lat_sum += lat
                self.offers_total += 1
                if rec.admitted:
                    self.admitted_total += 1
                    self._grants.append({
                        "job_id": rec.job.job_id,
                        "utility": rec.utility,
                        "schedule": (dict(rec.schedule.slots)
                                     if rec.schedule is not None else {}),
                    })
                if not sub.future.done():
                    sub.future.set_result(rec)
            self._grants_cv.notify_all()

    async def poll(self, worker_id: str, timeout: float = 30.0,
                   max_items: int = 16) -> List[dict]:
        """Long-poll for granted offers: blocks until a grant is queued,
        the service closes, or the timeout lapses (-> ``[]``). Raises
        ``LookupError`` for an unknown or heartbeat-expired worker."""
        info = self.workers.get(worker_id)
        if info is None or self.clock() - info.last_seen > self.heartbeat_timeout:
            raise LookupError(f"unknown or expired worker {worker_id!r}")
        async with self._grants_cv:
            if not self._grants and not self._closed:
                try:
                    await asyncio.wait_for(
                        self._grants_cv.wait_for(
                            lambda: self._grants or self._closed),
                        timeout,
                    )
                except asyncio.TimeoutError:
                    return []
            out = []
            while self._grants and len(out) < max_items:
                out.append(self._grants.popleft())
            return out

    # -- observability --------------------------------------------------
    def admission_latency(self) -> Dict[str, float]:
        return {
            "count": self._lat_n,
            "mean_ms": (self._lat_sum / self._lat_n * 1e3
                        if self._lat_n else 0.0),
            "p50_ms": self._lat_p50.value() * 1e3,
            "p99_ms": self._lat_p99.value() * 1e3,
        }

    def _publish(self) -> None:
        reg = get_registry()
        reg.gauge("repro_service_workers_alive",
                  "registered workers within heartbeat timeout"
                  ).set(len(self.alive_workers()))
        reg.gauge("repro_service_grants_pending",
                  "granted offers not yet long-polled"
                  ).set(len(self._grants))
        reg.gauge("repro_service_offers_total",
                  "jobs offered through the service").set(self.offers_total)
        reg.gauge("repro_service_admitted_total",
                  "admitted offers").set(self.admitted_total)
        reg.gauge("repro_service_batches_total",
                  "admission batches dispatched").set(self.batches_total)
        reg.gauge("repro_service_evictions_total",
                  "workers evicted on heartbeat expiry"
                  ).set(self.evictions_total)
        lat = self.admission_latency()
        for k in ("p50_ms", "p99_ms", "mean_ms"):
            reg.gauge(f"repro_service_admission_latency_{k}",
                      "submit->decision latency").set(lat[k])

    def metrics_text(self) -> str:
        """Prometheus-style exposition: the whole process registry
        (tracing/solver/engine series included) plus the service gauges
        published just-in-time."""
        self._publish()
        return get_registry().render()

    # -- minimal HTTP front-end ----------------------------------------
    async def start_http(self, host: str = "127.0.0.1",
                         port: int = 0) -> "asyncio.AbstractServer":
        """Serve ``/register``, ``/heartbeat``, ``/workers`` and
        ``/metrics`` over a minimal HTTP/1.1 loop (close-delimited
        responses; offer submission stays on the Python API)."""
        return await asyncio.start_server(self._handle_http, host, port)

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            length = 0
            while True:
                hdr = await reader.readline()
                if hdr in (b"\r\n", b"\n", b""):
                    break
                name, _, val = hdr.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    length = int(val.strip())
            body = await reader.readexactly(length) if length else b""
            status, ctype, payload = self._route(method, path, body)
            writer.write(
                f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n".encode("latin-1") + payload)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            writer.close()

    def _route(self, method: str, path: str, body: bytes):
        try:
            if method == "GET" and path == "/metrics":
                return ("200 OK", "text/plain; version=0.0.4",
                        self.metrics_text().encode())
            if method == "GET" and path == "/workers":
                return ("200 OK", "application/json",
                        json.dumps(self.workers_snapshot()).encode())
            if method == "POST" and path == "/register":
                req = json.loads(body or b"{}")
                out = self.register(str(req["worker_id"]),
                                    int(req.get("cores", 1)))
                return ("200 OK", "application/json",
                        json.dumps(out).encode())
            if method == "POST" and path == "/heartbeat":
                req = json.loads(body or b"{}")
                ok = self.heartbeat(str(req.get("worker_id", "")))
                return ("200 OK", "application/json",
                        json.dumps({"ok": ok}).encode())
        except (KeyError, ValueError, json.JSONDecodeError):
            return ("400 Bad Request", "application/json",
                    b'{"error": "bad request"}')
        return ("404 Not Found", "application/json",
                b'{"error": "not found"}')
