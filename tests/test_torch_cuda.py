"""The port's CUDA kernels on the card: the offer path's two kernels
against their plain torch versions bit for bit, and the model's two
(rmsnorm, flash attention on both routes: bf16 on the tensor cores,
float32 on the CUDA cores) within their tolerances; the offer path on a
CUDA ledger launching both of its kernels and deciding as the CPU run
does; the online simulator's clean, chaos, recover, elastic and
service paths on a CUDA ledger deciding as ``repro.sim`` on numpy or as
the CPU run does, with the checkpoint's ledger still on the card; the
reduced serving path launching both model kernels and answering as the
CPU run does. Skipped where there is no card; on one,
run ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, minplus, pricing, rmsnorm
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def _bundle_case(seed, W, H, R, zero_cols=False, edges=False):
    """price, free on the host and the (wdem, sdem): free spans negative
    (over-committed) values; ``zero_cols`` zeroes demand columns,
    ``edges`` puts NaN, -inf and exact multiples of the demand in free."""
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.1, 8.1, (W, H, R))
    free = rng.uniform(-3.0, 30.0, (W, H, R))
    wdem = rng.uniform(0.0, 3.0, R)
    sdem = rng.uniform(0.0, 3.0, R)
    if zero_cols:
        wdem[::2] = 0.0
        sdem[1::3] = 0.0
    if edges:
        free.reshape(-1)[::7] = np.nan
        free.reshape(-1)[3::11] = -np.inf
        free[..., 0] = 3.0 * wdem[0]
    return price, free, wdem, sdem


BUNDLE_CASES = [  # W, H, R, zero-demand columns, NaN / -inf / exact free
    (20, 100, 4, False, False), (20, 100, 4, True, True), (1, 100, 4, False,
                                                           False),
    (37, 1000, 7, True, True), (5, 33, 1, False, True), (5, 33, 1, True,
                                                         False),
    (20, 100, 8, True, True), (3, 129, 8, False, False), (20, 100, 7, False,
                                                          False),
    (20, 100, 3, True, True), (2, 17, 6, True, True), (4, 9, 2, False, True),
]


@pytest.mark.parametrize("W,H,R,zero_cols,edges", BUNDLE_CASES)
def test_price_bundle_kernel_matches_plain(cuda, W, H, R, zero_cols, edges):
    price, free, wdem, sdem = _bundle_case(W * H + R, W, H, R, zero_cols,
                                           edges)
    price, free = torch.from_numpy(price).to(cuda), \
        torch.from_numpy(free).to(cuda)
    gamma = 8.789275684645638        # coef's product rounds
    _equal(pricing.price_bundle_batch_cuda(price, free, wdem, sdem, gamma),
           pricing.price_bundle_batch_torch(price, free, wdem, sdem, gamma))


@pytest.mark.parametrize("R", [4, 8])
def test_price_bundle_kernel_element_loads_match_plain(cuda, R):
    """Operands one double off a 16-byte boundary: element loads."""
    price, free, wdem, sdem = _bundle_case(R, 20, 100, R, True, True)
    n = price.size

    def unaligned(a):
        return torch.from_numpy(np.concatenate([[0.0], a.ravel()])) \
            .to(cuda)[1:].view(a.shape)
    price, free = unaligned(price), unaligned(free)
    assert price.data_ptr() % 16 == 8 and price.numel() == n
    assert pricing.bundle_vec(R, False) == 1
    _equal(pricing.price_bundle_batch_cuda(price, free, wdem, sdem, 2.5),
           pricing.price_bundle_batch_torch(price, free, wdem, sdem, 2.5))


def test_price_bundle_host_call_matches_cpu(cuda):
    """The backend's host-level call: the same five arrays on both
    devices, and a result that a later call does not overwrite."""
    price, free, wdem, sdem = _bundle_case(3, 20, 100, 4, True, True)
    want = pricing.price_bundle_batch(torch.from_numpy(price),
                                      torch.from_numpy(free), wdem, sdem, 4.0)
    price_d = torch.from_numpy(price).to(cuda)
    free_d = torch.from_numpy(free).to(cuda)
    got = pricing.price_bundle_batch(price_d, free_d, wdem, sdem, 4.0)
    pricing.price_bundle_batch(price_d * 2, free_d, wdem, sdem, 4.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="R <= 8"):
        pricing.price_bundle_batch(torch.ones((1, 2, 9), device=cuda,
                                              dtype=torch.float64),
                                   torch.ones((1, 2, 9), device=cuda,
                                              dtype=torch.float64),
                                   np.ones(9), np.ones(9), 1.0)


#: run in a process of its own: after torch.profiler runs that traced
#: these copies, later profiles in the same process came back empty
_COPY_COUNT = """
import json, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import minplus, pricing
rng = np.random.default_rng(0)
price = torch.from_numpy(rng.uniform(0.1, 8.0, (20, 100, 4))).cuda()
free = torch.from_numpy(rng.uniform(-3.0, 30.0, (20, 100, 4))).cuda()
wdem, sdem = rng.uniform(0.0, 3.0, 4), rng.uniform(0.0, 3.0, 4)
tcost = rng.uniform(0.0, 100.0, (20, 21))
calls = {"price_bundle_kernel": lambda: pricing.price_bundle_batch(
             price, free, wdem, sdem, 4.0),
         "minplus_sweep_kernel": lambda: minplus.minplus_sweep_host(
             tcost, "cuda")}
out = {}
for name, call in calls.items():
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
    counts = {"kernel": 0, "HtoD": 0, "DtoH": 0}
    for ev in prof.key_averages():
        for key in counts:
            if (key == "kernel" and name in ev.key) or \\
                    f"Memcpy {key}" in ev.key:
                counts[key] += ev.count
    out[name] = counts
print(json.dumps(out))
"""


def test_host_calls_make_one_copy_each_way(cuda):
    """A plan's bundle makes one launch and one copy back, no copy in;
    the DP's sweep one copy in, one launch, one copy back (CUDA activity
    under torch.profiler, in a process of its own)."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    run = subprocess.run([sys.executable, "-c", _COPY_COUNT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    counts = json.loads(run.stdout.strip().splitlines()[-1])
    assert counts == {
        "price_bundle_kernel": {"kernel": 1, "HtoD": 0, "DtoH": 1},
        "minplus_sweep_kernel": {"kernel": 1, "HtoD": 1, "DtoH": 1},
    }, counts


def _near_tie_tcost(seed, k, Q1, mag):
    """tcost on a 0.1 * mag grid (sums of different decompositions tie
    exactly or to an ulp) with absolute offsets of 0.5e-12 to 3e-12, so
    rows hold ties and near-ties on both sides of the 1e-12 hysteresis;
    a few +inf entries, v = 0 free."""
    rng = np.random.default_rng(seed)
    tc = np.round(rng.uniform(0.0, 5.0, (k, Q1)), 1) * mag
    tc += rng.choice([0.0, 5e-13, -5e-13, 1e-12, -1e-12, 1.5e-12, 2e-12,
                      -2e-12, 3e-12], size=tc.shape)
    tc[rng.random((k, Q1)) < 0.1] = np.inf
    tc[:, 0] = 0.0
    return tc


def _random_tcost(seed, k, Q1):
    rng = np.random.default_rng(seed)
    tc = rng.uniform(0.0, 100.0, (k, Q1))
    tc[rng.random((k, Q1)) < 0.2] = np.inf
    tc[:, 0] = 0.0
    return tc


def _sweeps_equal(tcost, cuda):
    t = torch.from_numpy(tcost).to(cuda)
    got = minplus.minplus_sweep_cuda(t)
    want = minplus.minplus_sweep_torch(t)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 3, 20, 200])
@pytest.mark.parametrize("Q1", [1, 2, 21, 32, 33, 49, 100, 129, 1024])
def test_minplus_sweep_kernel_matches_plain(cuda, k, Q1):
    """Random rows at every width and depth: groups of 1 to 32 lanes a
    row up to Q1 = 128, the scan past it; k = 200 at Q1 >= 21 and every
    sweep past Q1 = 128 streams tcost through the ring."""
    _sweeps_equal(_random_tcost(k * Q1, k, Q1), cuda)


@pytest.mark.parametrize("mag", [1.0, 1e3, 1e6])
@pytest.mark.parametrize("k,Q1", [(20, 21), (20, 33), (200, 49), (20, 100),
                                  (3, 1024)])
def test_minplus_sweep_kernel_near_ties_match_plain(cuda, mag, k, Q1):
    tcost = _near_tie_tcost(int(mag) + Q1, k, Q1, mag)
    _sweeps_equal(tcost, cuda)


def test_minplus_sweep_kernel_unreachable_rows_match_plain(cuda):
    for tcost in (np.full((4, 21), np.inf), np.full((3, 2), np.inf),
                  np.full((200, 1024), np.inf)):
        _sweeps_equal(tcost, cuda)
        tcost[:, 0] = 0.0                    # reachable only at u = 0
        _sweeps_equal(tcost, cuda)


def test_minplus_sweep_host_call_matches_cpu(cuda):
    """The DP's host-level call: identical tables on both devices, and
    a result that a later call does not overwrite."""
    tcost = _near_tie_tcost(5, 20, 21, 1.0)
    want = minplus.minplus_sweep_host(tcost, "cpu")
    got = minplus.minplus_sweep_host(tcost, cuda)
    minplus.minplus_sweep_host(tcost * 2, cuda)          # reuses the buffers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_offer_path_launches_both_kernels_and_matches_cpu(cuda):
    cfg = rt.WorkloadConfig(num_jobs=8, horizon=10, seed=3, batch=(30, 150),
                            workload_scale=0.1)
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    gpu = rt.run_pdors(rt.synthetic_jobs(cfg), rt.make_cluster(6, 10),
                       quanta=8, seed=0)
    assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0
    cpu = rt.run_pdors(rt.synthetic_jobs(cfg),
                       rt.make_cluster(6, 10, device="cpu"), quanta=8, seed=0)
    assert [r.admitted for r in gpu.records] == \
        [r.admitted for r in cpu.records]
    assert gpu.total_utility == pytest.approx(cpu.total_utility, rel=1e-9)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", [
    (4096, 3072), (4, 3072), (1000, 128), (96, 512), (3, 50),
    # Command R+'s d_model, DeepSeek-V2's, an MLA rank, single-element
    # rows, single rows
    (16, 12288), (33, 5120), (7, 1536), (300, 1), (1, 3072), (1, 12288),
    (1, 50),
])
def test_rmsnorm_kernel_matches_plain(cuda, N, d, dtype):
    gen = torch.Generator().manual_seed(N + d)
    x = (torch.randn((N, d), generator=gen) * 3).to(dtype).to(cuda)
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    got = rmsnorm.rmsnorm_cuda(x, scale)
    want = rmsnorm.rmsnorm_torch(x, scale)
    assert got.dtype == dtype
    tol = dict(rtol=8e-3, atol=1e-6) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_unaligned_input_matches_plain(cuda, dtype):
    """x one element off a 16-byte boundary: the element-wise path."""
    gen = torch.Generator().manual_seed(11)
    N, d = 6, 3072
    x = (torch.randn((N * d + 1,), generator=gen) * 3).to(dtype).to(cuda)
    x = x[1:].view(N, d)
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    assert x.data_ptr() % 16 != 0
    assert rmsnorm.rmsnorm_layout(d, dtype, False).width == 1
    got = rmsnorm.rmsnorm_cuda(x, scale)
    want = rmsnorm.rmsnorm_torch(x, scale)
    tol = dict(rtol=8e-3, atol=1e-6) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", [(4096, 3072), (4, 3072), (64, 128)])
def test_rmsnorm_kernel_is_deterministic(cuda, N, d, dtype):
    """No atomics and a fixed order of sums: two launches agree bit for
    bit."""
    gen = torch.Generator().manual_seed(12)
    x = (torch.randn((N, d), generator=gen) * 3).to(dtype).to(cuda)
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    _equal(rmsnorm.rmsnorm_cuda(x, scale).float(),
           rmsnorm.rmsnorm_cuda(x, scale).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S_q,S_k,H,KV,D,causal,window", [
    (2, 256, 256, 4, 4, 256, True, 0),
    (2, 512, 512, 64, 8, 128, True, 0),
    (1, 200, 200, 2, 1, 64, True, 0),
    (1, 128, 256, 2, 2, 32, False, 0),
    (1, 256, 256, 2, 2, 32, True, 32),
    (1, 256, 256, 2, 2, 32, True, 128),
    (1, 300, 100, 2, 2, 48, False, 8),
    (1, 200, 200, 4, 2, 80, True, 0),      # D no multiple of 16
    (1, 64, 64, 2, 2, 20, True, 0),        # D no multiple of 8
    (1, 512, 512, 16, 16, 256, True, 0),   # Gemma-7B's heads
    (1, 130, 130, 2, 1, 50, True, 0),      # D no multiple of 4
])
def test_flash_kernel_matches_plain(cuda, B, S_q, S_k, H, KV, D, causal,
                                    window, dtype):
    gen = torch.Generator().manual_seed(S_q * H + D)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(cuda)
               for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                             (B, S_k, KV, D)))
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window)
    want = flash_attention.flash_attention_torch(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.float32, 256),
                                     (torch.float32, 80)])
def test_flash_kernel_unaligned_inputs_match_plain(cuda, dtype, D):
    """q, k, v one element (2 or 4 bytes) off a 16-byte boundary: either
    kernel takes its element-wise loader."""
    gen = torch.Generator().manual_seed(8 + D)
    shape = (1, 192, 4, D)
    n = int(np.prod(shape))
    q, k, v = (torch.randn((n + 1,), generator=gen).to(dtype)
               .to(cuda)[1:].view(shape) for _ in range(3))
    assert not flash_attention.vector_loads(D, q, k, v)
    got = flash_attention.flash_attention_cuda(q, k, v, True, 0)
    want = flash_attention.flash_attention_torch(q, k, v, True, 0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_deterministic(cuda, dtype):
    """No atomics and a fixed order of sums: two launches agree bit for
    bit."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, 512, 16, 256), generator=gen).to(dtype)
               .to(cuda) for _ in range(3))
    first = flash_attention.flash_attention_cuda(q, k, v)
    second = flash_attention.flash_attention_cuda(q, k, v)
    _equal(first.float(), second.float())


@pytest.mark.parametrize("dtype,tensor_cores", [(torch.bfloat16, True),
                                                (torch.float32, False)])
def test_flash_route_by_dtype(cuda, dtype, tensor_cores):
    """bf16 launches the tensor-core kernel, float32 the CUDA-core one."""
    from torch.profiler import ProfilerActivity, profile
    q = torch.randn((1, 128, 2, 64), device=cuda).to(dtype)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention.flash_attention_cuda(q, q, q)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if "flash_fwd_kernel" in ev.key]
    assert len(names) == 1, names
    assert ("flash_fwd_kernel_tc" in names[0]) == tensor_cores


def test_flash_kernel_window_one_is_v(cuda):
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((1, 128, 1, 16), generator=gen).to(cuda)
               for _ in range(3))
    got = flash_attention.flash_attention_cuda(q * 3, k * 3, v, True, 1)
    torch.testing.assert_close(got, v, rtol=1e-5, atol=1e-5)


def test_reduced_serving_launches_both_kernels_and_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma-7b", reduced=True)
    params = build_model(cfg).init(0, cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                    max_new_tokens=12) for i in range(8)]
    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    gpu = ServeEngine(cfg, params, max_batch=4, cache_len=128).serve(reqs)
    forwards = 2 * 12              # two batches: one prefill, 11 decodes
    assert rmsnorm.LAUNCHES == forwards * (2 * cfg.num_layers + 1)
    assert flash_attention.LAUNCHES == 2 * cfg.num_layers
    cpu = ServeEngine(cfg, copy.deepcopy(params).to("cpu"), max_batch=4,
                      cache_len=128).serve(reqs)
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.tokens, c.tokens)


# ------------------------------------------------------ online simulator
# the smoke grid's pdors at test_torch_pdors.py's GOLDEN seeds, and the
# three slot-driven baselines
SIM_CASES = [("pdors", 0), ("pdors", 3), ("pdors", 7), ("pdors", 11),
             ("fifo", 0), ("drf", 0), ("dorm", 0)]


@pytest.mark.parametrize("name,seed", SIM_CASES)
def test_sim_on_the_card_matches_numpy_backend(cuda, name, seed):
    """The online simulator on a CUDA ledger decides as ``repro.sim`` on
    the numpy backend: identical decision logs and summaries, utility
    within rel 1e-9; pdors launches both offer kernels on every plan and
    sweep."""
    from repro_torch.obs import trace
    from test_torch_sim import (SMOKE, assert_same_run, make_port_engine,
                                make_ref_engine, run_logged)
    point = dict(SMOKE, seed=seed)
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    with trace.activate(tracer):
        got = run_logged(*make_port_engine(name, device=cuda, **point))
    want = run_logged(*make_ref_engine(name, **point))
    assert_same_run(got, want)
    if name == "pdors":
        spans = [sp for sp in tracer.spans
                 if sp.name in ("plan.bundle", "dp.sweep")]
        assert {sp.attrs["backend"] for sp in spans} == {"cuda"}
        # every plan's bundle is one launch; offers built outside a plan
        # launch per slot snapshot
        assert pricing.LAUNCHES >= sum(sp.name == "plan.bundle"
                                       for sp in spans) > 0
        assert minplus.LAUNCHES == sum(sp.name == "dp.sweep"
                                       for sp in spans) > 0


def test_full_sim_point_on_the_card_matches_numpy_backend(cuda):
    """chip_smoke.py's sim point (bench_sim.py's FULL_GRID row 2, 500
    jobs on 16 machines), pdors on the card against the numpy backend."""
    from test_torch_sim import (assert_same_run, make_port_engine,
                                make_ref_engine, run_logged)
    point = dict(machines=16, lookahead=16, preset="google", jobs=500,
                 rate=6.0, failure_rate=0.05, seed=0, quanta=12,
                 calib_jobs=48)
    got = run_logged(*make_port_engine("pdors", device=cuda, **point))
    want = run_logged(*make_ref_engine("pdors", **point))
    assert_same_run(got, want)


def test_run_oasis_on_the_card_matches_cpu(cuda):
    """OASiS's two pseudo-resources: the bundle kernel at R = 6."""
    cfg = rt.WorkloadConfig(num_jobs=10, horizon=12, seed=6, batch=(20, 100),
                            workload_scale=0.1)
    pricing.LAUNCHES = 0
    gpu = rt.core.run_oasis(rt.synthetic_jobs(cfg), rt.make_cluster(8, 12),
                            quanta=12)
    assert pricing.LAUNCHES > 0
    cpu = rt.core.run_oasis(rt.synthetic_jobs(cfg),
                            rt.make_cluster(8, 12, device="cpu"), quanta=12)
    trace_of = [(r.job.job_id, r.admitted, None if r.schedule is None else
                 {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                  for t, a in r.schedule.slots.items()})
                for res in (gpu, cpu) for r in res.records]
    half = len(trace_of) // 2
    assert trace_of[:half] == trace_of[half:]
    assert gpu.total_utility == pytest.approx(cpu.total_utility, rel=1e-9)


# ------------------------------------- chaos, recovery, elastic, service
# launch.sim's point (bench_sim's smoke point) with each tier's knobs
LAUNCH_POINT = dict(machines=6, lookahead=12, preset="google", jobs=60,
                    rate=3.0, failure_rate=0.1, seed=0)


def _ref_chaos_engine(name, machines, lookahead, preset, jobs, rate,
                      failure_rate, seed):
    """bench_sim's ``run_point(faults=True)`` engine for ``name`` on the
    JAX package's numpy backend, and its merged stream."""
    import repro.core as ref_core
    import repro.sim as ref_sim
    from repro_torch.launch import sim as launch_sim

    tcfg = ref_sim.TraceConfig(preset=preset, num_jobs=jobs, seed=seed,
                               arrival_rate=rate, failure_rate=failure_rate)
    plan = ref_sim.FaultPlan(**{
        f: getattr(launch_sim.chaos_plan(seed, machines), f)
        for f in ("seed", "until", "crash_rate", "straggler_rate",
                  "downtime", "domains", "domain_correlation",
                  "solver_fault_rate")})
    cl = ref_core.make_cluster(machines, lookahead, backend="numpy")
    if name.startswith("pdors"):
        policy = ref_sim.ResilientPolicy(
            inner=name, quanta=launch_sim.QUANTA,
            price_params=ref_sim.calibrate_prices(tcfg, cl,
                                                  n=launch_sim.CALIB_JOBS),
            cfg=ref_core.SubproblemConfig(
                lp_fault_hook=plan.solver_fault_hook()))
    else:
        policy = ref_sim.make_policy(name)
    engine = ref_sim.SimEngine(ref_sim.RollingWindow(cl), policy, seed=seed,
                               max_slots=launch_sim.MAX_SLOTS,
                               patience=tcfg.patience)
    return engine, ref_sim.merge_event_streams(ref_sim.stream(tcfg),
                                               plan.events(machines))


@pytest.mark.parametrize("name", ["pdors", "fifo", "drf", "dorm"])
def test_chaos_on_the_card_matches_numpy_backend(cuda, name):
    """``launch.sim --faults`` at the smoke point on a CUDA ledger: the
    chaos leg (pdors resilient-wrapped, injected LP faults, crashes and
    stragglers in the capacity mask) decides as ``repro.sim`` on numpy;
    pdors launches both offer kernels, every span on cuda."""
    from repro_torch.launch import sim as launch_sim
    from repro_torch.obs import trace
    from test_torch_sim import assert_same_run, run_logged
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    with trace.activate(tracer):
        got = run_logged(*launch_sim.make_engine(
            name, device=cuda, faults=True, **LAUNCH_POINT))
    want = run_logged(*_ref_chaos_engine(name, **LAUNCH_POINT))
    assert_same_run(got, want)
    assert got[0].summary["machine_incidents"] > 0
    if name == "pdors":
        assert got[0].summary["policy_health"]["solver_faults"] > 0
        spans = [sp for sp in tracer.spans
                 if sp.name in ("plan.bundle", "dp.sweep")]
        assert {sp.attrs["backend"] for sp in spans} == {"cuda"}
        assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0


def test_recover_on_the_card_is_bit_identical(cuda):
    """Kill the chaos run on a CUDA ledger and recover: the checkpoint's
    ledger is still on the card with caches that agree with a fresh read,
    and the recovered run (restored at slot 20, the slots up to the kill
    at 27 run again from the regenerated stream) equals the uninterrupted
    one."""
    from repro_torch.launch import sim as launch_sim
    from repro_torch.sim import SimKilled
    from test_torch_faults import assert_cluster_caches_fresh
    base_eng, events = launch_sim.make_engine("pdors", device=cuda,
                                              faults=True, **LAUNCH_POINT)
    base = base_eng.run(events)
    eng, events = launch_sim.make_engine(
        "pdors", device=cuda, faults=True, checkpoint_every=10, kill_at=27,
        **LAUNCH_POINT)
    with pytest.raises(SimKilled):
        eng.run(events)
    assert eng._checkpoint.slot == 20
    assert_cluster_caches_fresh(eng._checkpoint.state[0].cluster, "cuda")
    rep = eng.recover(launch_sim.make_events(faults=True, **LAUNCH_POINT))
    assert rep.summary == base.summary
    assert rep.slots_run == base.slots_run
    assert eng.metrics.outcomes == base_eng.metrics.outcomes
    cl = eng.window.cluster
    assert_cluster_caches_fresh(cl, "cuda")
    assert torch.equal(cl._used, base_eng.window.cluster._used)


def test_elastic_on_the_card_matches_cpu(cuda):
    """``launch.sim --elastic`` for pdors: both engine modes bit-identical
    on the card, and the batched run identical to the CPU's."""
    from repro_torch.launch import sim as launch_sim
    from test_torch_sim import assert_same_run, run_logged
    runs = {}
    for device, mode in ((cuda, "batched"), (cuda, "event"),
                         ("cpu", "batched")):
        engine, events = launch_sim.make_engine(
            "pdors", device=device, elastic=True, engine_mode=mode,
            **LAUNCH_POINT)
        runs[str(device), mode] = (run_logged(engine, events), engine)
    (gb, eb), (ge, _) = runs["cuda", "batched"], runs["cuda", "event"]
    assert gb[0].summary == ge[0].summary
    assert gb[0].slots_run == ge[0].slots_run
    assert gb[0].summary["reshapes"] > 0
    assert_same_run(gb, runs["cpu", "batched"][0])
    assert eb.window.cluster._used.device.type == "cuda"


def test_service_on_the_card_matches_offer_batch_on_cpu(cuda):
    """The service row on a CUDA ledger: each batch the service formed,
    offered through ``PDORS.offer_batch`` on the CPU in the same order,
    gives the same admissions and schedules."""
    from repro_torch.launch import sim as launch_sim
    point = dict(LAUNCH_POINT, jobs=300)
    sched, jobs = launch_sim.make_service_point(device=cuda, **point)
    batches = []
    inner = sched.offer_batch

    def offer_batch(batch):
        batches.append([j.job_id for j in batch])
        return inner(batch)

    sched.offer_batch = offer_batch
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    run = launch_sim.drive_service(sched, jobs, point["machines"])
    assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0
    assert len(batches) == run["batches"]
    assert sorted(j for b in batches for j in b) == \
        sorted(j.job_id for j in jobs)
    cpu, cpu_jobs = launch_sim.make_service_point(device="cpu", **point)
    by_id = {j.job_id: j for j in cpu_jobs}
    want = [r for b in batches for r in cpu.offer_batch(
        [by_id[i] for i in b])]

    def decided(recs):
        return {r.job.job_id: (r.admitted, None if r.schedule is None else
                               {t: (sorted(a.workers.items()),
                                    sorted(a.ps.items()))
                                for t, a in r.schedule.slots.items()})
                for r in recs}

    assert decided(run["records"]) == decided(want)
    assert run["grants"] == sum(r.admitted for r in want) > 0
