"""The port's asyncio ``OfferService`` (``repro_torch.sim.service``) over
``PDORS.offer_batch`` on ``TorchBackend(device="cpu")``: long-poll grant
round trips, heartbeat eviction, concurrent-batch admission determinism,
the ``/metrics`` exposition, graceful shutdown, reshaped re-offers and the
minimal HTTP front-end, as ``tests/test_service.py`` holds the JAX
package's; and the admissions and schedules the port's service gives
equal to ``repro``'s service on the numpy backend for the same jobs."""
from __future__ import annotations

import asyncio
import json
from dataclasses import replace

import pytest

import repro.core as ref_core
import repro.sim as ref_sim
from repro.core.pdors import PDORS as RefPDORS
from repro_torch.core import ElasticProfile, QualityCurve, make_cluster
from repro_torch.core.pdors import PDORS
from repro_torch.core.pricing import estimate_price_params
from repro_torch.sim import OfferService, TraceConfig, sample_jobs


def _jobs(n=24, seed=5):
    return sample_jobs(TraceConfig(num_jobs=n, seed=seed, arrival_rate=4.0),
                       n)


def _scheduler(jobs, H=6, W=24, quanta=8):
    cl = make_cluster(H, W, device="cpu")
    return PDORS(cl, estimate_price_params(jobs, cl, cl.horizon),
                 quanta=quanta)


def _ref_scheduler(jobs, H=6, W=24, quanta=8):
    cl = ref_core.make_cluster(H, W, backend="numpy")
    return RefPDORS(cl, ref_core.estimate_price_params(jobs, cl, cl.horizon),
                    quanta=quanta)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _decided(recs) -> dict:
    return {r.job.job_id: (r.admitted, None if r.schedule is None else {
        t: (sorted(a.workers.items()), sorted(a.ps.items()))
        for t, a in sorted(r.schedule.slots.items())}) for r in recs}


async def _drain(svc, worker="w0", **kw):
    grants = []
    while True:
        more = await svc.poll(worker, timeout=0.05, **kw)
        if not more:
            return grants
        grants.extend(more)


# ----------------------------------------------------------------------
def test_long_poll_round_trip():
    async def main():
        jobs = _jobs()
        svc = await OfferService(_scheduler(jobs), batch_window=0.001).start()
        svc.register("w0", cores=4)
        poller = asyncio.create_task(svc.poll("w0", timeout=5.0))
        await asyncio.sleep(0.01)
        assert not poller.done()
        recs = await asyncio.gather(*[svc.submit(j) for j in jobs])
        admitted = sum(r.admitted for r in recs)
        assert admitted > 0
        grants = list(await poller) + await _drain(svc)
        assert len(grants) == admitted
        assert {g["job_id"] for g in grants} == \
            {r.job.job_id for r in recs if r.admitted}
        for g in grants:
            assert g["schedule"], "admitted grant carries its schedule"
        await svc.close()

    asyncio.run(main())


def test_heartbeat_expiry_eviction():
    async def main():
        clock = FakeClock()
        svc = await OfferService(_scheduler(_jobs()), heartbeat_timeout=10.0,
                                 clock=clock).start()
        svc.register("w0", cores=2)
        svc.register("w1", cores=2)
        clock.t += 8.0
        assert svc.heartbeat("w0")
        clock.t += 4.0
        assert svc.evict_expired() == ["w1"]
        snap = svc.workers_snapshot()
        assert [w["worker_id"] for w in snap["workers"]] == ["w0"]
        with pytest.raises(LookupError):
            await svc.poll("w1", timeout=0.01)
        assert not svc.heartbeat("w1")
        assert svc.evictions_total == 1
        await svc.close()

    asyncio.run(main())


def test_concurrent_batch_admission_determinism():
    """Concurrent submissions land in one batch, sorted by job_id: the
    admissions and schedules equal one ``offer_batch`` over the same jobs
    on a fresh ledger, and ``repro``'s ``offer_batch`` on numpy."""
    async def main():
        jobs = _jobs(n=20, seed=9)
        svc = await OfferService(_scheduler(jobs),
                                 batch_window=0.002).start()
        recs = await asyncio.gather(*[svc.submit(j) for j in reversed(jobs)])
        await svc.close()
        return svc, recs

    jobs = _jobs(n=20, seed=9)
    svc, recs = asyncio.run(main())
    assert svc.batches_total == 1
    via_batch = _scheduler(jobs).offer_batch(
        sorted(jobs, key=lambda j: j.job_id))
    assert _decided(recs) == _decided(via_batch)
    ref_jobs = ref_sim.sample_jobs(ref_sim.TraceConfig(
        num_jobs=20, seed=9, arrival_rate=4.0), 20)
    assert _decided(recs) == _decided(_ref_scheduler(ref_jobs).offer_batch(
        sorted(ref_jobs, key=lambda j: j.job_id)))
    assert any(a for a, _ in _decided(recs).values())


@pytest.mark.parametrize("n,seed,window,chunk", [(40, 1, 0.001, 8),
                                                 (30, 11, 0.0005, 64)])
def test_service_admissions_match_repro_service(n, seed, window, chunk):
    """The same jobs, submitted ``chunk`` at a time, through the port's
    service and ``repro``'s: the same batches, admissions and schedules,
    and the same grants long-polled."""
    async def drive(pkg, sched, jobs):
        svc = await pkg.OfferService(sched, batch_window=window).start()
        svc.register("w0", cores=4)
        recs = []
        for i in range(0, len(jobs), chunk):
            recs.extend(await asyncio.gather(
                *[svc.submit(j) for j in jobs[i:i + chunk]]))
        grants = await _drain(svc, max_items=256)
        await svc.close()
        return recs, [g["job_id"] for g in grants], svc.batches_total

    import repro_torch.sim as port_sim
    got = asyncio.run(drive(port_sim, _scheduler(_jobs(n, seed)),
                            _jobs(n, seed)))
    ref_jobs = ref_sim.sample_jobs(ref_sim.TraceConfig(
        num_jobs=n, seed=seed, arrival_rate=4.0), n)
    want = asyncio.run(drive(ref_sim, _ref_scheduler(ref_jobs), ref_jobs))
    assert _decided(got[0]) == _decided(want[0])
    assert got[1] == want[1] and got[1]
    assert got[2] == want[2] == -(-n // chunk)


def test_metrics_exposition_schema():
    async def main():
        jobs = _jobs(n=12, seed=2)
        svc = await OfferService(_scheduler(jobs), batch_window=0.001).start()
        svc.register("w0")
        await asyncio.gather(*[svc.submit(j) for j in jobs])
        text = svc.metrics_text()
        for series in (
            "repro_service_offers_total",
            "repro_service_admitted_total",
            "repro_service_batches_total",
            "repro_service_workers_alive",
            "repro_service_grants_pending",
            "repro_service_admission_latency_p50_ms",
            "repro_service_admission_latency_p99_ms",
        ):
            assert f"\n{series} " in text or text.startswith(f"{series} "), \
                series
        assert "# HELP repro_service_offers_total" in text
        lat = svc.admission_latency()
        assert lat["count"] == len(jobs)
        assert lat["p99_ms"] >= lat["p50_ms"] >= 0.0
        await svc.close()

    asyncio.run(main())


def test_graceful_shutdown_no_dropped_offers():
    async def main():
        jobs = _jobs(n=16, seed=7)
        svc = await OfferService(_scheduler(jobs), batch_window=30.0).start()
        svc.register("w0", cores=2)
        subs = [asyncio.create_task(svc.submit(j)) for j in jobs]
        await asyncio.sleep(0.01)
        assert not any(t.done() for t in subs)
        await svc.close()
        recs = await asyncio.gather(*subs)
        assert len(recs) == len(jobs)
        admitted = sum(r.admitted for r in recs)
        assert admitted > 0
        assert svc.offers_total == len(jobs)
        assert len(await _drain(svc)) == admitted
        with pytest.raises(RuntimeError):
            await svc.submit(jobs[0])

    asyncio.run(main())


# ------------------------------------------------ reshape / requeue churn
def _elastify(job, level=1):
    return replace(job, elastic=ElasticProfile(
        levels=(0.5, 1.0, 1.5), level=level,
        curve=QualityCurve(a=0.8, b=1.0, c=0.1)))


def _gauge(text, name):
    for line in text.splitlines():
        if line.startswith(f"{name} "):
            return float(line.split()[1])
    raise AssertionError(f"gauge {name} missing from exposition")


def test_reshape_reoffer_changed_signature_round_trip():
    async def main():
        jobs = [_elastify(j) for j in _jobs(n=8, seed=13)]
        svc = await OfferService(_scheduler(jobs, W=48),
                                 batch_window=0.001).start()
        svc.register("w0", cores=4)
        first = await asyncio.gather(*[svc.submit(j) for j in jobs])
        admitted = [r.job for r in first if r.admitted]
        assert admitted
        reoffers = [j.at_level(0) for j in admitted]
        for orig, down in zip(admitted, reoffers):
            assert down.job_id == orig.job_id
            assert down.worker_demand != orig.worker_demand
        second = await asyncio.gather(*[svc.submit(j) for j in reoffers])
        assert len(second) == len(reoffers)
        for rec in second:
            assert rec.job.elastic.level == 0
        assert svc.offers_total == len(jobs) + len(reoffers)
        grants = await _drain(svc)
        assert len(grants) == sum(r.admitted for r in first + second)
        await svc.close()

    asyncio.run(main())


def test_long_poll_grant_ordering_under_requeue_churn():
    async def main():
        jobs = [_elastify(j) for j in _jobs(n=10, seed=21)]
        svc = await OfferService(_scheduler(jobs, W=48),
                                 batch_window=0.002).start()
        svc.register("w0", cores=4)
        first = await asyncio.gather(*[svc.submit(j) for j in jobs])
        batch1 = [r.job.job_id for r in first if r.admitted]
        assert batch1 == sorted(batch1)
        reoffers = [r.job.at_level(0) for r in first if r.admitted]
        second = await asyncio.gather(
            *[svc.submit(j) for j in reversed(reoffers)])
        batch2 = sorted(r.job.job_id for r in second if r.admitted)
        assert svc.batches_total == 2
        drained = [g["job_id"] for g in await _drain(svc, max_items=3)]
        assert drained == batch1 + batch2
        await svc.close()

    asyncio.run(main())


def test_shutdown_flush_with_pending_reoffers():
    async def main():
        jobs = [_elastify(j) for j in _jobs(n=8, seed=3)]
        svc = await OfferService(_scheduler(jobs, W=48),
                                 batch_window=0.001).start()
        svc.register("w0", cores=2)
        first = await asyncio.gather(*[svc.submit(j) for j in jobs])
        admitted = [r.job for r in first if r.admitted]
        assert admitted
        while await svc.poll("w0", timeout=0.05):
            pass
        svc.batch_window = 30.0
        pending = [asyncio.create_task(svc.submit(j.at_level(2)))
                   for j in admitted]
        await asyncio.sleep(0.01)
        assert not any(t.done() for t in pending)
        await svc.close()
        recs = await asyncio.gather(*pending)
        assert len(recs) == len(admitted)
        assert svc.offers_total == len(jobs) + len(admitted)
        assert len(await _drain(svc)) == sum(r.admitted for r in recs)
        with pytest.raises(RuntimeError):
            await svc.submit(admitted[0])

    asyncio.run(main())


def test_metrics_slo_gauges_consistent_under_churn():
    async def main():
        jobs = [_elastify(j) for j in _jobs(n=10, seed=6)]
        svc = await OfferService(_scheduler(jobs, W=48),
                                 batch_window=0.001).start()
        svc.register("w0", cores=4)
        first = await asyncio.gather(*[svc.submit(j) for j in jobs])
        reoffers = [r.job.at_level(0) for r in first if r.admitted]
        await asyncio.gather(*[svc.submit(j) for j in reoffers])
        text = svc.metrics_text()
        lat = svc.admission_latency()
        assert _gauge(text, "repro_service_offers_total") == svc.offers_total
        assert (_gauge(text, "repro_service_admitted_total")
                == svc.admitted_total)
        assert (_gauge(text, "repro_service_batches_total")
                == svc.batches_total)
        assert (_gauge(text, "repro_service_grants_pending")
                == len(svc._grants) > 0)
        for k in ("p50_ms", "p99_ms", "mean_ms"):
            assert _gauge(text, f"repro_service_admission_latency_{k}") \
                == pytest.approx(lat[k])
        assert lat["count"] == svc.offers_total
        assert lat["p99_ms"] >= lat["p50_ms"] >= 0.0
        while await svc.poll("w0", timeout=0.05):
            pass
        assert _gauge(svc.metrics_text(),
                      "repro_service_grants_pending") == 0
        await svc.close()

    asyncio.run(main())


def test_minimal_http_front_end():
    async def main():
        svc = await OfferService(_scheduler(_jobs())).start()
        server = await svc.start_http("127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]

        async def req(method, path, body=None):
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            payload = json.dumps(body).encode() if body is not None else b""
            writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                         f"Content-Length: {len(payload)}\r\n\r\n".encode()
                         + payload)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, data = raw.partition(b"\r\n\r\n")
            return head.split(b" ", 2)[1].decode(), data

        status, _ = await req("POST", "/register",
                              {"worker_id": "w0", "cores": 3})
        assert status == "200"
        status, body = await req("GET", "/workers")
        assert status == "200"
        assert json.loads(body)["total_slots"] == 3
        status, _ = await req("POST", "/heartbeat", {"worker_id": "w0"})
        assert status == "200"
        status, body = await req("GET", "/metrics")
        assert status == "200"
        assert b"repro_service_workers_alive" in body
        status, _ = await req("POST", "/register", {"cores": 2})
        assert status == "400"
        status, _ = await req("GET", "/nope")
        assert status == "404"
        server.close()
        await server.wait_closed()
        await svc.close()

    asyncio.run(main())
