"""The port's CUDA kernels on the card: the offer path's two kernels
against their plain torch versions bit for bit, and the model's two
(rmsnorm, flash attention on both routes: bf16 on the tensor cores,
float32 on the CUDA cores) within their tolerances; the offer path on a
CUDA ledger launching both of its kernels and deciding as the CPU run
does; the online simulator's clean, chaos, recover, elastic and
service paths on a CUDA ledger deciding as ``repro.sim`` on numpy or as
the CPU run does, with the checkpoint's ledger still on the card; the
reduced serving path (dense, MoE, MLA, vision, Mamba-2, Hymba and
SeamlessM4T) launching the model kernels and answering as the CPU run
does; rmsnorm's backward kernel against its plain version, its autograd
function reaching a float32 and a bf16 scale, raising on a failed
build, and a reduced train step on the card matching the CPU's; AdamW's
plain update in slabs writing what one piece writes, and its kernel
route writing what the plain route writes, bit for bit (past 2^31
elements too), its norm kernel deterministic and within float64 of the
sum, its launches counted and its refusals; one train
step of Command R+ at full width (1 layer, its vocab cut) matching the
CPU's; one full-width MoE layer routing as the CPU does, and one
full-width MLA layer of each MLA config, one Hymba block and one
SeamlessM4T decoder block computing as the CPU does; the dry run's
one-card plan of a reduced train step counting the real step's FLOPs
and argument bytes; the scheduler-driven training runtime
(``launch.cluster``) deciding and training as the CPU does. Skipped
where there is no card; on one, run ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, minplus, ops, pricing, \
    rmsnorm
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
    # Command R+'s serving rows (4 x 1024 prompt tokens, 4 decode rows)
    # and its training rows (16 x 64 tokens)
    (4096, 12288), (4, 12288), (1024, 12288),
    # MLA's q_norm / kv_norm on the prefill and decode rows: MiniCPM3
    # (768, 256) and DeepSeek-V2 (1536, 512)
    (4096, 768), (4096, 256), (2048, 1536), (2048, 512), (4, 768),
    (4, 256), (4, 1536), (4, 512),
    # Mamba-2 (1536; the gated norm at 3072), Hymba (1600, 3200) and
    # SeamlessM4T (1024) on their prefill and decode rows
    (4096, 1536), (8192, 1600), (8192, 3200), (6400, 1024), (4, 1600),
    (4, 3200), (4, 1024),
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


def _bwd_close(dx, ds, want_dx, want_ds, x, scale, dy):
    """The backward kernel's tolerances: float32 dx to 1e-5; bf16 dx to
    one bf16 ulp of its row's largest |dx|, plus 16 float32 ulps of its
    row's largest |r g| (``g - x r^2 mean(g x)`` cancels: at d = 1, dx =
    r g eps / (x^2 + eps), far below its terms, so the two float32
    computations differ by a few ulps of the terms before rounding);
    dscale to rtol 1e-5 (atol 1e-5 of its largest, for columns that sum
    to near zero)."""
    if dx.dtype == torch.bfloat16:
        x32 = x.float()
        r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
        terms = (r * dy.float() * scale.float()).abs().amax(-1, keepdim=True)
        big = want_dx.float().abs().amax(-1, keepdim=True)
        tol = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7) \
            + 16 * torch.exp2(torch.floor(torch.log2(
                terms.clamp_min(1e-30))) - 23)
        assert bool(((dx.float() - want_dx.float()).abs() <= tol).all())
    else:
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    atol = 1e-5 * float(want_ds.float().abs().max())
    torch.testing.assert_close(ds.float(), want_ds.float(), rtol=1e-5,
                               atol=atol)


def _bwd_case(gen, N, d, dtype, cuda):
    x = (torch.randn((N, d), generator=gen) * 3).to(dtype).to(cuda)
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    dy = torch.randn((N, d), generator=gen).to(dtype).to(cuda)
    return x, scale, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", [
    # the training shape (Gemma-7B, 2 x 4096 tokens), its decode rows,
    # single-element and odd rows, the widest row, slabs of 1 and of many
    # rows, narrow rows many to a block
    (8192, 3072), (4, 3072), (300, 1), (33, 77), (16, 16384), (1, 3072),
    (513, 256), (65536, 128), (1000, 128), (96, 512), (3, 50), (7, 1536),
    (4096, 4096),
    # the partition's edges: no row, one row, fewer rows than a block's
    # lanes, a last block part full; Qwen3-32B's and Command R+'s d_model
    # and the cluster's reduced rows
    (0, 128), (0, 3072), (1, 128), (5, 128), (8191, 128), (65535, 128),
    (8191, 3072), (1024, 5120), (1024, 12288), (1024, 256), (4096, 32),
    (4, 12288), (16, 12288),
])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, N, d, dtype):
    gen = torch.Generator().manual_seed(N + d)
    x, scale, dy = _bwd_case(gen, N, d, dtype, cuda)
    dx, ds = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    _bwd_close(dx, ds, *rmsnorm.rmsnorm_bwd_torch(x, scale, dy), x, scale,
               dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_unaligned_input_matches_plain(cuda, dtype):
    """x and dy one element off a 16-byte boundary: the element-wise
    path."""
    gen = torch.Generator().manual_seed(13)
    N, d = 40, 3072
    x, dy = ((torch.randn((N * d + 1,), generator=gen) * 3).to(dtype)
             .to(cuda)[1:].view(N, d) for _ in range(2))
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    assert x.data_ptr() % 16 != 0 and dy.data_ptr() % 16 != 0
    dx, ds = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    _bwd_close(dx, ds, *rmsnorm.rmsnorm_bwd_torch(x, scale, dy), x, scale,
               dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_unaligned_narrow_rows_match_plain(cuda, dtype):
    """Rows of at most 32 elements one element off a 16-byte boundary:
    the narrow path, element by element, several rows a lane."""
    gen = torch.Generator().manual_seed(15)
    N, d = 70000, 24
    x, dy = ((torch.randn((N * d + 1,), generator=gen) * 3).to(dtype)
             .to(cuda)[1:].view(N, d) for _ in range(2))
    scale = (torch.randn((d,), generator=gen) + 1.0).to(cuda)
    assert rmsnorm.rmsnorm_bwd_slabs(N, d, dtype, False).slab > 1
    dx, ds = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    _bwd_close(dx, ds, *rmsnorm.rmsnorm_bwd_torch(x, scale, dy), x, scale,
               dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d", [(8192, 3072), (4, 3072), (1000, 128),
                                 (8192, 128), (65536, 128), (1024, 12288)])
def test_rmsnorm_bwd_kernel_is_deterministic(cuda, N, d, dtype):
    """Partial sums over a partition fixed by the shape added in a fixed
    order, no atomics: two launches agree bit for bit, dscale
    included."""
    gen = torch.Generator().manual_seed(14)
    x, scale, dy = _bwd_case(gen, N, d, dtype, cuda)
    a = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    b = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    for u, v in zip(a, b):
        _equal(u.float(), v.float())


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_fn_gradient_reaches_the_scale(cuda, scale_dtype):
    """``ops.rmsnorm`` on the card under autograd: one forward and one
    backward launch, the gradient on x and on the scale parameter in its
    own dtype (the kernels read a float32 copy of it)."""
    gen = torch.Generator().manual_seed(15)
    x, scale, dy = _bwd_case(gen, 3 * 64, 1024, torch.bfloat16, cuda)
    x = x.view(3, 64, 1024).requires_grad_()
    w = torch.nn.Parameter(scale.to(scale_dtype))
    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    y = ops.rmsnorm(x, w)
    y.backward(dy.view(3, 64, 1024))
    assert (rmsnorm.LAUNCHES, rmsnorm.LAUNCHES_BWD) == (1, 1)
    assert w.grad is not None and w.grad.dtype == scale_dtype
    want_dx, want_ds = rmsnorm.rmsnorm_bwd_torch(x.detach(), w.detach(),
                                                 dy.view(3, 64, 1024))
    assert want_ds.dtype == scale_dtype
    _bwd_close(x.grad.view(-1, 1024), w.grad, want_dx.view(-1, 1024),
               want_ds, x.detach().view(-1, 1024), w.detach(), dy)


def test_rmsnorm_bwd_failed_build_raises_without_fallback(cuda,
                                                          monkeypatch):
    """With the backward's source failing to build, the backward raises:
    no plain version stands in on the card."""
    from repro_torch.kernels import _build

    x = torch.randn((8, 256), device=cuda, requires_grad=True)
    w = torch.nn.Parameter(torch.ones(256, device=cuda))
    y = ops.rmsnorm(x, w)        # the forward's entry, already loaded

    def failing_load(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", failing_load)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    launches = rmsnorm.LAUNCHES_BWD
    with pytest.raises(RuntimeError, match="rmsnorm_bwd"):
        y.sum().backward()
    assert rmsnorm.LAUNCHES_BWD == launches
    assert x.grad is None and w.grad is None


def test_reduced_training_on_the_card_matches_cpu(cuda):
    """Reduced Gemma (float32, TF32 off, remat "full") for one train step
    on the card and on the CPU from the same weights: every parameter gets
    a finite, non-zero gradient on the card, within 1e-4 of its tensor's
    largest CPU gradient; the loss to 1e-5; the norms' launches exact
    (each block's two norms run again in the backward)."""
    import dataclasses

    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_source
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              remat="full")
    model = build_model(cfg)
    opt = AdamWConfig()
    params = model.init(0, cuda)
    cpu_params = copy.deepcopy(params).to("cpu")
    batch = make_source(cfg, InputShape("t", 64, 4, "train")).batch(0)
    out = {}
    for name, p in (("cuda", params), ("cpu", cpu_params)):
        dev = next(p.parameters()).device
        state = {"params": p,
                 "opt": adamw_init(dict(p.named_parameters()), opt)}
        rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
        _, metrics = make_train_step(model, opt)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[name] = (float(metrics["loss"]),
                     {n: q.grad.cpu() for n, q in p.named_parameters()},
                     (rmsnorm.LAUNCHES, rmsnorm.LAUNCHES_BWD))
    L = cfg.num_layers
    assert out["cuda"][2] == ((2 * L + 1) + 2 * L, 2 * L + 1)
    assert out["cpu"][2] == (0, 0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, g in out["cuda"][1].items():
        want = out["cpu"][1][n]
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), n
        assert float((g - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), n


def _one_piece_norm(tensors):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tensors.values()))


@pytest.mark.parametrize("dtype,fp32_moments", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_adamw_slabs_equal_one_piece_on_the_card(cuda, monkeypatch, dtype,
                                                 fp32_moments):
    """Three AdamW steps on the plain route (``_plain`` patched to take
    the card's tensors) with the update in slabs of 4099 elements (no
    size here divides) write the params and moments of the one-piece
    update bit for bit, given the same grad norm; the slabbed norm is
    the one-piece norm within rel 1e-6."""
    from repro_torch.optim import AdamWConfig, adamw, adamw_init, \
        adamw_update, global_norm

    monkeypatch.setattr(adamw, "_plain", lambda t: True)
    gen = torch.Generator().manual_seed(5)
    shapes = {"table": (1000, 257), "w": (33, 17), "b": (7,)}
    p0 = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    g0 = {n: torch.randn(s, generator=gen) * 0.5 for n, s in shapes.items()}
    cfg = AdamWConfig(fp32_moments=fp32_moments)
    one = _one_piece_norm({n: g.to(cuda) for n, g in g0.items()})
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 4099)
    slabbed = global_norm({n: g.to(cuda) for n, g in g0.items()})
    assert abs(float(slabbed) - float(one)) <= 1e-6 * float(one)
    monkeypatch.setattr(adamw, "global_norm", _one_piece_norm)
    runs = []
    for size in (1 << 26, 4099):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", size)
        params = {n: t.to(dtype).to(cuda) for n, t in p0.items()}
        state = adamw_init(params, cfg)
        for step in range(3):
            grads = {n: (g * (step + 1)).to(dtype).to(cuda)
                     for n, g in g0.items()}
            params, state, _ = adamw_update(params, grads, state, cfg,
                                            torch.tensor(0.5, device=cuda))
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for n in shapes:
        for a, b in ((p1[n], p2[n]), (s1["m"][n], s2["m"][n]),
                     (s1["v"][n], s2["v"][n])):
            assert a.dtype == b.dtype and torch.equal(a, b), n


def _flat_view(values: torch.Tensor, dtype, off: int, device):
    """``values`` in ``dtype`` on ``device``, as a view ``off`` elements
    into a fresh buffer: 16-byte aligned at off 0, else off by off * the
    element size."""
    buf = torch.zeros(values.numel() + 16, dtype=dtype, device=device)
    view = buf[off:off + values.numel()].view(values.shape)
    view.copy_(values)
    return view


#: name: (shape, elements the param, its gradient, m and v lie off a
#: 16-byte boundary): sizes that no 8 divides, a 0-d tensor, all four off
#: alike (a head of elements before the first whole chunk) and off unlike
#: (element-wise chunks)
ADAMW_CASES = {"table": ((999, 257), (0, 0, 0, 0)),
               "w": ((33, 17), (0, 0, 0, 0)), "b": ((7,), (0, 0, 0, 0)),
               "s": ((), (0, 0, 0, 0)), "off": ((61, 7), (1, 1, 1, 1)),
               "odd": ((5, 9), (1, 2, 0, 0))}


@pytest.mark.parametrize("dtype,fp32_moments", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
@pytest.mark.parametrize("grad_clip", [1.0, 100.0])
def test_adamw_kernel_route_writes_the_plain_routes_bits(
        cuda, monkeypatch, dtype, fp32_moments, grad_clip):
    """Three AdamW steps on the kernel route and on the plain slabbed
    route, on the card from the same state and gradients, write the same
    params and moments bit for bit, given the same grad norm (the
    one-piece sum: ``global_norm`` patched), zero moments included; one
    update launch a tensor a step."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import AdamWConfig, adamw, adamw_update

    gen = torch.Generator().manual_seed(6)
    p0 = {n: torch.randn(s, generator=gen)
          for n, (s, _) in ADAMW_CASES.items()}
    g0 = {n: torch.randn(s, generator=gen) * 0.5
          for n, (s, _) in ADAMW_CASES.items()}
    for t in g0.values():
        t.view(-1)[::5] = 1e-12            # |g| near eps, and zero
        t.view(-1)[1::7] = 0.0             # gradients: zero moments
    cfg = AdamWConfig(grad_clip=grad_clip, fp32_moments=fp32_moments)
    mdt = torch.float32 if fp32_moments else dtype
    monkeypatch.setattr(adamw, "global_norm", _one_piece_norm)
    runs = []
    for plain in (False, True):
        monkeypatch.setattr(adamw, "_plain", lambda t, plain=plain: plain)
        params = {n: _flat_view(p0[n], dtype, offs[0], cuda)
                  for n, (_, offs) in ADAMW_CASES.items()}
        state = {"m": {n: _flat_view(torch.zeros(s), mdt, offs[2], cuda)
                       for n, (s, offs) in ADAMW_CASES.items()},
                 "v": {n: _flat_view(torch.zeros(s), mdt, offs[3], cuda)
                       for n, (s, offs) in ADAMW_CASES.items()},
                 "step": torch.zeros((), dtype=torch.int32, device=cuda)}
        launches = kadamw.LAUNCHES
        for step in range(3):
            grads = {n: _flat_view(g0[n] * (step + 1), dtype, offs[1], cuda)
                     for n, (_, offs) in ADAMW_CASES.items()}
            params, state, _ = adamw_update(params, grads, state, cfg,
                                            torch.tensor(0.5 + 0.25 * step,
                                                         device=cuda))
        assert kadamw.LAUNCHES - launches == (0 if plain
                                              else 3 * len(ADAMW_CASES))
        runs.append((params, state))
    # "off": every pointer off 16 bytes, aligned together some elements in
    # (a head before the first chunk); "odd": the param and its gradient
    # off by unlike amounts, so no element aligns both (single elements)
    (p1, s1), (p2, s2) = runs
    assert all(t.data_ptr() % 16 for t in (p1["off"], grads["off"],
                                           s1["m"]["off"], s1["v"]["off"]))
    assert p1["odd"].data_ptr() % 16 != grads["odd"].data_ptr() % 16
    for n in ADAMW_CASES:
        for a, b in ((p1[n], p2[n]), (s1["m"][n], s2["m"][n]),
                     (s1["v"][n], s2["v"][n])):
            assert a.dtype == b.dtype and torch.equal(a, b), n


def test_adamw_kernel_past_two_to_the_31_writes_the_plain_routes_bits(
        cuda, monkeypatch):
    """One bf16 tensor of 2^31 + 9 elements (64-bit indices; the tied
    table of Command R+ has 3.15e9): one kernel-route step writes the
    plain route's params and moments bit for bit, given the same norm;
    the norm kernel reads it within rel 1e-6 of a float64 sum."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import AdamWConfig, adamw, adamw_update

    n = (1 << 31) + 9
    gen = torch.Generator(device=cuda).manual_seed(7)
    p0 = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
    g = (torch.randn(n, generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
    want = sum(float(torch.sum(part.double() ** 2))
               for part in g.split(1 << 28)) ** 0.5
    norm = kadamw.global_norm_cuda([g])
    assert abs(float(norm) - want) <= 1e-6 * want
    monkeypatch.setattr(adamw, "global_norm", lambda grads: norm)
    cfg = AdamWConfig()
    runs = []
    for plain in (False, True):
        monkeypatch.setattr(adamw, "_plain", lambda t, plain=plain: plain)
        params = {"table": p0.clone()}
        state = {"m": {"table": torch.zeros_like(p0)},
                 "v": {"table": torch.zeros_like(p0)},
                 "step": torch.zeros((), dtype=torch.int32, device=cuda)}
        adamw_update(params, {"table": g}, state, cfg)
        runs.append((params["table"], state["m"]["table"],
                     state["v"]["table"]))
        del params, state
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_norm_kernel_is_deterministic_and_within_float64(cuda, dtype):
    """The norm kernel over gradients of several sizes (one of 3,000,001
    elements, a 0-d one, a view off 16 bytes) is within rel 1e-6 of the
    float64 sum of their float32 squares and the same bits in two calls."""
    from repro_torch.kernels import adamw as kadamw

    gen = torch.Generator().manual_seed(9)
    shapes = [(3_000_001,), (4096, 1000), (7,), (), (257, 3)]
    grads = [torch.randn(s, generator=gen).to(dtype).to(cuda) for s in shapes]
    grads.append(_flat_view(torch.randn(1001, generator=gen), dtype, 3, cuda))
    want = sum(float(torch.sum(g.float().double() ** 2)) for g in grads) ** 0.5
    launches = kadamw.LAUNCHES
    a = kadamw.global_norm_cuda(grads)
    b = kadamw.global_norm_cuda(grads)
    assert kadamw.LAUNCHES - launches == 2 * (len(grads) + 1)
    assert a.dtype == torch.float32 and a.shape == ()
    assert torch.equal(a, b)
    assert abs(float(a) - want) <= 1e-6 * want


def test_adamw_step_launches_and_span_on_the_kernel_route(cuda):
    """A step over T param tensors makes 2T + 1 launches (T sums of
    squares, the norm's last pass, T updates); ``train.adamw`` records
    route ``kernel``, the param count and T update launches, each in its
    own ``train.adamw.slab``."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.obs import trace
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    gen = torch.Generator().manual_seed(10)
    shapes = {"table": (1000, 257), "w": (33, 17), "b": (7,)}
    params = {n: torch.randn(s, generator=gen).to(torch.bfloat16).to(cuda)
              for n, s in shapes.items()}
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    state = adamw_init(params, AdamWConfig())
    tracer = trace.Tracer()
    for step in range(2):
        launches = kadamw.LAUNCHES
        with trace.activate(tracer):
            _, state, _ = adamw_update(params, grads, state, AdamWConfig())
        assert kadamw.LAUNCHES - launches == 2 * len(shapes) + 1
    torch.cuda.synchronize()
    opt = [sp for sp in tracer.spans if sp.name == "train.adamw"]
    n = sum(p.numel() for p in params.values())
    assert [sp.attrs for sp in opt] == [
        {"route": "kernel", "elements": n, "slabs": len(shapes)}] * 2
    slabs = [sp for sp in tracer.spans if sp.name == "train.adamw.slab"]
    assert [sp.attrs["elements"] for sp in slabs] == \
        [p.numel() for p in params.values()] * 2
    assert int(state["step"]) == 2


@pytest.mark.parametrize("case", ["float16", "grad_dtype", "cpu_moment"])
def test_adamw_refuses_on_the_card_what_the_kernels_do_not_take(cuda, case):
    """A float16 param, a gradient of another dtype than its param, or a
    moment left on the CPU raises before any launch: no route takes it."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    dtype = torch.float16 if case == "float16" else torch.bfloat16
    params = {"w": torch.ones((33, 17), dtype=dtype, device=cuda)}
    grads = {"w": torch.ones_like(params["w"])}
    state = adamw_init(params, AdamWConfig())
    if case == "grad_dtype":
        grads["w"] = grads["w"].float()
    elif case == "cpu_moment":
        state["m"]["w"] = state["m"]["w"].cpu()
    launches = kadamw.LAUNCHES
    with pytest.raises(ValueError):
        adamw_update(params, grads, state, AdamWConfig())
    assert kadamw.LAUNCHES == launches


def test_full_width_command_r_plus_step_matches_cpu(cuda):
    """One train step of Command R+ at full width (d 12,288, 96 query
    heads over 8 kv heads, d_ff 33,792) cut to 1 layer and a vocab of
    1024, float32 (TF32 off), on the card and on the CPU from the same
    weights and batch: the loss to rel 1e-5, every gradient finite,
    non-zero and within 1e-4 of its tensor's largest CPU gradient; the
    norms' launches exact."""
    import dataclasses

    from repro_torch.configs.base import InputShape
    from repro_torch.models import concrete_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("command-r-plus-104b"),
                              num_layers=1, vocab_size=1024,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    gpu = model.init(0, cuda)
    cpu = type(gpu)(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    batch = concrete_batch(cfg, InputShape("t", 64, 2, "train"), seed=0,
                           device="cpu")
    out = {}
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
        _, metrics = make_train_step(model, opt)(
            train_state(params, opt),
            {k: v.to(name) for k, v in batch.items()})
        out[name] = (float(metrics["loss"]),
                     {n: q.grad.cpu() for n, q in params.named_parameters()},
                     (rmsnorm.LAUNCHES, rmsnorm.LAUNCHES_BWD))
        del metrics
    assert out["cuda"][2] == (3 + 2, 3) and out["cpu"][2] == (0, 0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, g in out["cuda"][1].items():
        want = out["cpu"][1][n]
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), n
        assert float((g - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), n


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
    (1, 2048, 2048, 25, 5, 64, True, 1024),  # Hymba's sliding window
    (1, 128, 1600, 16, 16, 64, False, 0),  # SeamlessM4T's cross-attention
    (1, 1600, 1600, 16, 16, 64, False, 0),  # and its encoder
    (2, 256, 256, 96, 8, 128, True, 0),    # Command R+'s group of 12
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
                                     (torch.float32, 80),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256)])
def test_flash_kernel_unaligned_inputs_match_plain(cuda, dtype, D):
    """q, k, v one element (2 or 4 bytes) off a 16-byte boundary: the
    float32 kernel takes its element-wise loader, the bf16 wrapper copies
    them into aligned buffers for the same TMA kernel."""
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


#: the bf16 kernel's edges: (B, S_q, S_k, H, KV, D, causal, window)
TC_EDGES = [
    (1, 200, 333, 4, 4, 128, False, 0),    # S_q, S_k off every tile
    (2, 300, 300, 4, 2, 64, True, 0),
    (1, 130, 70, 2, 2, 256, False, 0),     # S_k under one 64-key tile
    (2, 100, 40, 4, 4, 128, True, 0),      # under one 128-key tile, S_q > S_k
    (1, 257, 257, 8, 8, 72, True, 0),      # D 72 and 80: the 128 bucket
    (1, 200, 200, 4, 2, 80, False, 0),
    (1, 136, 136, 2, 2, 40, True, 0),      # D 40: a box wider than the row
    (2, 256, 256, 5, 1, 64, True, 0),      # query groups of 5, 8 and 12
    (1, 384, 384, 16, 2, 128, True, 0),
    (1, 256, 256, 24, 2, 256, True, 0),
    (1, 512, 512, 4, 4, 128, True, 100),   # window edges inside tiles
    (1, 520, 520, 4, 2, 256, True, 200),
    (1, 300, 300, 2, 2, 64, False, 77),    # a window without the mask
    (1, 256, 256, 4, 4, 128, True, 1),     # window 1
    (1, 300, 100, 2, 2, 64, False, 8),     # rows with no allowed key
    (4, 128, 1600, 16, 16, 64, False, 0),  # SeamlessM4T's cross-attention
]


@pytest.mark.parametrize("q_rows", [64, 128])
@pytest.mark.parametrize("B,S_q,S_k,H,KV,D,causal,window", TC_EDGES)
def test_tc_kernel_edges_match_plain(cuda, monkeypatch, q_rows, B, S_q,
                                     S_k, H, KV, D, causal, window):
    """The bf16 kernel at its edges, in both instances (the pick by
    shape moved by ``SM_COUNT``): within bf16 2e-2 of the plain version,
    one launch a call, and bit for bit the same on a second call."""
    monkeypatch.setattr(flash_attention, "SM_COUNT",
                        1 if q_rows == 128 else 1 << 30)
    assert flash_attention.tc_tiles(B, S_q, H, D).q_rows == q_rows
    gen = torch.Generator().manual_seed(S_q * H + D + window)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(cuda)
               for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                             (B, S_k, KV, D)))
    launches = flash_attention.LAUNCHES
    got = flash_attention.flash_attention_cuda(q, k, v, causal, window)
    again = flash_attention.flash_attention_cuda(q, k, v, causal, window)
    assert flash_attention.LAUNCHES == launches + 2
    want = flash_attention.flash_attention_torch(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    _equal(got.float(), again.float())


@pytest.mark.parametrize("D", [64, 128, 256])
def test_tc_kernel_is_deterministic_at_each_bucket(cuda, D):
    """Every sum in a fixed order: two launches agree bit for bit at each
    padded width, causal and not, in the instance the shape picks."""
    gen = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn((2, 1000, 32, D), generator=gen)
               .to(torch.bfloat16).to(cuda) for _ in range(3))
    assert flash_attention.tc_tiles(2, 1000, 32, D).q_rows == 128
    for causal in (True, False):
        first = flash_attention.flash_attention_cuda(q, k, v, causal)
        second = flash_attention.flash_attention_cuda(q, k, v, causal)
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


def test_flash_kernel_at_llava_prefill_matches_plain(cuda):
    """bf16 at LLaVA-NeXT's prefill: 2880 image + 128 text tokens, 47
    tiles of 64, 32 query heads over 8 kv heads of 128."""
    gen = torch.Generator().manual_seed(3008)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(cuda)
               for shape in ((4, 3008, 32, 128), (4, 3008, 8, 128),
                             (4, 3008, 8, 128)))
    got = flash_attention.flash_attention_cuda(q, k, v, True, 0)
    want = flash_attention.flash_attention_torch(q, k, v, True, 0)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


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


def test_reduced_moe_serving_launches_both_kernels_and_matches_cpu(cuda):
    """Reduced Phi-3.5-MoE (float32, TF32 off): prefill routes groups of
    64 tokens and decode groups of 4 at the default capacity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    params = build_model(cfg).init(0, cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 32).astype(np.int32),
                    max_new_tokens=12) for i in range(8)]
    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    gpu = ServeEngine(cfg, params, max_batch=4, cache_len=64).serve(reqs)
    forwards = 2 * 12              # two batches: one prefill, 11 decodes
    assert rmsnorm.LAUNCHES == forwards * (2 * cfg.num_layers + 1)
    assert flash_attention.LAUNCHES == 2 * cfg.num_layers
    cpu = ServeEngine(cfg, copy.deepcopy(params).to("cpu"), max_batch=4,
                      cache_len=64).serve(reqs)
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.tokens, c.tokens)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b",
                                  "llava-next-mistral-7b"])
def test_reduced_mla_and_vision_serving_match_cpu(cuda, arch):
    """Reduced MiniCPM3, DeepSeek-V2 and LLaVA-NeXT (float32, TF32 off)
    through ``Model.prefill`` (LLaVA with image embeddings) and 7 decode
    steps: exact launch counts (MLA: four norms a layer, no flash) and
    the CPU's greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(0, cuda)
    on_cpu = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 16))).long()}
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(4, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32))

    def greedy(params, batch):
        logits, state = model.prefill(params, batch, 48)
        out = [logits[:, -1].argmax(-1, keepdim=True)]
        for _ in range(7):
            logits, state = model.decode(params, out[-1], state)
            out.append(logits[:, -1].argmax(-1, keepdim=True))
        return torch.cat(out, dim=1).cpu()

    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    gpu = greedy(params, {k: v.to(cuda) for k, v in batch.items()})
    mla = cfg.attention == "mla"
    assert rmsnorm.LAUNCHES == 8 * ((4 if mla else 2) * cfg.num_layers + 1)
    assert flash_attention.LAUNCHES == (0 if mla else cfg.num_layers)
    _equal(gpu, greedy(on_cpu, batch))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
def test_full_width_mla_layer_matches_cpu(cuda, arch):
    """One full-width MLA layer in float32 (TF32 off): the absorbed
    branch over a latent cache (a 256-token prefill, then 2 decode steps)
    and the expanded branch, each within 1e-4 of the CPU; the two norms
    launch the rmsnorm kernel once each a forward."""
    from repro_torch.models.attention import MLA, init_mla_cache
    from repro_torch.models.layers import init_params_
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    layer = init_params_(MLA(cfg, cuda),
                         torch.Generator(device=cuda).manual_seed(0))
    on_cpu = MLA(cfg, "cpu")
    on_cpu.load_state_dict(layer.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 258, cfg.d_model), generator=gen)
    pos = torch.arange(258, dtype=torch.int32)
    caches = {d: init_mla_cache(cfg, 2, 264, torch.float32, d)
              for d in ("cuda", "cpu")}
    rmsnorm.LAUNCHES = 0
    with torch.no_grad():
        for lo, hi in ((0, 256), (256, 257), (257, 258)):
            y_gpu, _ = layer(x[:, lo:hi].to(cuda), pos[lo:hi].to(cuda),
                             cache=caches["cuda"], prefill=lo == 0)
            y_cpu, _ = on_cpu(x[:, lo:hi], pos[lo:hi], cache=caches["cpu"],
                              prefill=lo == 0)
            torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4,
                                       atol=1e-4)
        y_gpu, _ = layer(x[:, :64].to(cuda), pos[:64].to(cuda))
        y_cpu, _ = on_cpu(x[:, :64], pos[:64])
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    assert rmsnorm.LAUNCHES == 2 * 4
    for name in ("c_kv", "k_rope"):
        torch.testing.assert_close(caches["cuda"][name].cpu(),
                                   caches["cpu"][name], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_reduced_ssm_hybrid_and_encdec_serving_match_cpu(cuda, arch):
    """Reduced Mamba-2, Hymba and SeamlessM4T (float32, TF32 off) through
    ``Model.prefill`` (SeamlessM4T with frame embeddings) and 7 decode
    steps: exact launch counts (Mamba-2: 2 norms a layer, no flash;
    Hymba: 5 norms a layer and a flash call a layer a prefill;
    SeamlessM4T: 2 a layer per encode and 3 a decoder layer a forward,
    and flash for the encoder's, the decoder's and the cross-attention
    layers a prefill) and the CPU's greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(0, cuda)
    on_cpu = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 16))).long()}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(4, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32))

    def greedy(params, batch):
        logits, state = model.prefill(params, batch, 32)
        out = [logits[:, -1].argmax(-1, keepdim=True)]
        for _ in range(7):
            logits, state = model.decode(params, out[-1], state)
            out.append(logits[:, -1].argmax(-1, keepdim=True))
        return torch.cat(out, dim=1).cpu()

    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    gpu = greedy(params, {k: v.to(cuda) for k, v in batch.items()})
    L, E = cfg.num_layers, cfg.encoder_layers
    norms = {"mamba2-780m": 2, "hymba-1.5b": 5, "seamless-m4t-medium": 3}
    want_norms = 8 * (norms[arch] * L + 1) + (2 * E + 1 if E else 0)
    want_flash = {"mamba2-780m": 0, "hymba-1.5b": L,
                  "seamless-m4t-medium": E + 2 * L}[arch]
    assert rmsnorm.LAUNCHES == want_norms
    assert flash_attention.LAUNCHES == want_flash
    _equal(gpu, greedy(on_cpu, batch))


def test_full_width_hymba_layer_matches_cpu(cuda):
    """One full-width Hymba block in float32 (TF32 off): a 1280-token
    prefill with the 1024 window (the flash route cuts it) and 2 decode
    steps, then the same block as a global layer without a cache; each
    within 1e-4 of the CPU, the SSM state too; 5 norms a forward and one
    flash call a prefill."""
    from repro_torch.models.blocks import Block, init_block_cache
    from repro_torch.models.layers import init_params_
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    block = init_params_(Block(cfg, cuda),
                         torch.Generator(device=cuda).manual_seed(0))
    on_cpu = Block(cfg, "cpu")
    on_cpu.load_state_dict(block.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 1282, cfg.d_model), generator=gen)
    pos = torch.arange(1282, dtype=torch.int32)
    caches = {d: init_block_cache(cfg, 1, 1288, torch.float32, d)
              for d in ("cuda", "cpu")}
    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    with torch.no_grad():
        for lo, hi in ((0, 1280), (1280, 1281), (1281, 1282)):
            y_gpu, _, _ = block(x[:, lo:hi].to(cuda), pos[lo:hi].to(cuda),
                                1024, cache=caches["cuda"], prefill=lo == 0)
            y_cpu, _, _ = on_cpu(x[:, lo:hi], pos[lo:hi], 1024,
                                 cache=caches["cpu"], prefill=lo == 0)
            torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4,
                                       atol=1e-4)
        y_gpu, _, _ = block(x[:, :256].to(cuda), pos[:256].to(cuda), None)
        y_cpu, _, _ = on_cpu(x[:, :256], pos[:256], None)
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    assert rmsnorm.LAUNCHES == 5 * 4
    assert flash_attention.LAUNCHES == 1
    torch.testing.assert_close(caches["cuda"]["ssm"]["state"].cpu(),
                               caches["cpu"]["ssm"]["state"], rtol=1e-4,
                               atol=1e-4)


def test_full_width_seamless_decoder_layer_matches_cpu(cuda):
    """One full-width SeamlessM4T decoder block in float32 (TF32 off)
    over 1600 random encoder frames: a 128-token prefill (self and
    cross-attention through the flash kernel) and 2 decode steps
    (``grouped_attention``), each within 1e-4 of the CPU; 3 norms a
    forward, 2 flash calls in the prefill."""
    from repro_torch.models.blocks import Block, init_block_cache
    from repro_torch.models.layers import init_params_
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("seamless-m4t-medium")
    block = init_params_(Block(cfg, cuda, cross_attention=True),
                         torch.Generator(device=cuda).manual_seed(0))
    on_cpu = Block(cfg, "cpu", cross_attention=True)
    on_cpu.load_state_dict(block.state_dict())
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 130, cfg.d_model), generator=gen)
    enc = torch.randn((2, 1600, cfg.d_model), generator=gen)
    pos = torch.arange(130, dtype=torch.int32)
    kpos = torch.arange(1600, dtype=torch.int32)
    caches = {d: init_block_cache(cfg, 2, 136, torch.float32, d)
              for d in ("cuda", "cpu")}
    rmsnorm.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    with torch.no_grad():
        for lo, hi in ((0, 128), (128, 129), (129, 130)):
            y_gpu, _, _ = block(x[:, lo:hi].to(cuda), pos[lo:hi].to(cuda),
                                None, cache=caches["cuda"], prefill=lo == 0,
                                encoder_out=enc.to(cuda),
                                encoder_positions=kpos.to(cuda))
            y_cpu, _, _ = on_cpu(x[:, lo:hi], pos[lo:hi], None,
                                 cache=caches["cpu"], prefill=lo == 0,
                                 encoder_out=enc, encoder_positions=kpos)
            torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4,
                                       atol=1e-4)
    assert rmsnorm.LAUNCHES == 3 * 3
    assert flash_attention.LAUNCHES == 2


def _routing_gap(probs, k):
    """Per token, the least gap between consecutive router
    probabilities among its k + 1 largest."""
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(dim=-1).values


def test_full_width_moe_layer_matches_cpu(cuda):
    """One full-width Phi-3.5-MoE layer in float32 (TF32 off) on 512
    tokens, one group (C = 80): the routing (top-k and keep mask) is
    identical at every token whose gap exceeds 1e-6, y within 1e-4."""
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params_
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    layer = init_params_(moe.MoE(cfg, cuda),
                         torch.Generator(device=cuda).manual_seed(0))
    on_cpu = moe.MoE(cfg, "cpu")
    on_cpu.load_state_dict(layer.state_dict())
    x = torch.randn((2, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_gpu, aux_gpu = layer(x.to(cuda))
        y_cpu, aux_cpu = on_cpu(x)
        xg = moe.group_tokens(cfg.moe, x)
        r_gpu = moe.route(cfg, layer.router, xg.to(cuda))
        r_cpu = moe.route(cfg, on_cpu.router, xg)
    stable = _routing_gap(r_cpu.probs, cfg.moe.top_k) > 1e-6
    assert stable.float().mean() > 0.99
    _equal(r_gpu.top_idx[stable.to(cuda)], r_cpu.top_idx[stable])
    _equal(r_gpu.keep[stable.to(cuda)], r_cpu.keep[stable])
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    assert abs(float(aux_gpu) - float(aux_cpu)) <= 1e-6
    # the forward reads nothing back to the host
    xd = x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            layer(xd)
    finally:
        torch.cuda.set_sync_debug_mode("default")


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


def test_one_card_plan_equals_a_step_on_the_card(cuda):
    """The dry run's plan of a reduced train step on this card's host
    mesh (one device, nccl) counts the FLOPs ``FlopCounterMode`` counts
    for the real step on the card, and its arguments hold the bytes of
    the params, moments, step and batch the step takes; the real step
    launches both norm kernels."""
    import dataclasses

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_source
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import host_world, make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_state, make_train_step

    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              num_layers=2)
    shape = InputShape("t", 128, 2, "train")
    with host_world():
        plan = dryrun.dryrun_one("gemma-7b", "t", cfg_override=cfg,
                                 shape_override=shape,
                                 mesh_override=make_host_mesh(),
                                 verbose=False)
    assert not dist.is_initialized()
    model = build_model(cfg)
    state = make_train_state(model, 0, AdamWConfig(), "cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_source(cfg, shape, 0).batch(0).items()}
    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    with FlopCounterMode(display=False) as fc:
        state, _ = make_train_step(model, AdamWConfig())(state, batch)
    torch.cuda.synchronize()
    assert rmsnorm.LAUNCHES > 0 and rmsnorm.LAUNCHES_BWD > 0
    assert plan["flops"] == fc.get_total_flops()
    held = [*state["params"].parameters(), *state["opt"]["m"].values(),
            *state["opt"]["v"].values(), state["opt"]["step"],
            *batch.values()]
    assert plan["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in held)


def test_cluster_runtime_on_the_card_matches_cpu(cuda, monkeypatch):
    """``launch.cluster`` at ``tests/test_examples.py``'s point (4 slots,
    4 jobs, one step a slot) on the card and on the CPU: the schedule on a
    CUDA ledger decides as the CPU's and launches both offer kernels; the
    admitted jobs (reduced DeepSeek-V2, SeamlessM4T and Mamba-2, float32,
    TF32 off) train on the card from the same initial params and batches
    as on the CPU, each slot's loss within 1e-5, with rmsnorm's forward
    and backward launched once per norm a step (9, 12 and 5 norms)."""
    from repro_torch.launch import cluster
    from repro_torch.models import concrete_batch

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    pricing.LAUNCHES = minplus.LAUNCHES = 0
    res = cluster.schedule(None, 4, 4, cuda)
    assert pricing.LAUNCHES > 0 and minplus.LAUNCHES > 0
    cpu_res = cluster.schedule(None, 4, 4, "cpu")

    def decided(r):
        return [(x.job.job_id, x.admitted,
                 None if x.schedule is None else
                 {t: (a.workers, a.ps) for t, a in x.schedule.slots.items()})
                for x in r.records]

    assert decided(res) == decided(cpu_res)
    assert [r.job.arch for r in res.admitted] == [
        "deepseek-v2-236b", "seamless-m4t-medium", "mamba2-780m"]
    initial, batches = {}, {}

    def init_gpu(job_id, model, device):
        params = model.init(job_id, device)
        initial[job_id] = (type(params), {
            k: v.cpu() for k, v in params.state_dict().items()})
        return params

    def batch_gpu(cfg, shape, seed, device):
        batch = concrete_batch(cfg, shape, seed=seed, device=device)
        batches[seed] = {k: v.cpu() for k, v in batch.items()}
        return batch

    def init_cpu(job_id, model, device):
        cls, state = initial[job_id]
        params = cls(model.cfg, device)
        params.load_state_dict(state)
        return params

    def cfg_for(aid):
        return get_config(aid, reduced=True)

    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    got = cluster.run_jobs(res, cfg_for, 4, 1, cuda, init=init_gpu,
                           batch_for=batch_gpu)
    assert (rmsnorm.LAUNCHES, rmsnorm.LAUNCHES_BWD) == (53, 53)
    want = cluster.run_jobs(cpu_res, cfg_for, 4, 1, "cpu", init=init_cpu,
                            batch_for=lambda cfg, shape, seed, device:
                            batches[seed])
    assert sorted(got) == sorted(want) == [0, 1, 3]
    for jid, losses in want.items():
        np.testing.assert_allclose(got[jid], losses, rtol=0, atol=1e-5)


def test_spans_hold_their_launch_calls_on_the_profilers_clock(cuda):
    """Under a profiler session recording CUDA activity alone (the
    benchmark's), with no tracer installed, spans go to the session
    tracer and stamp the clock of the profiler's host calls: each span
    holds the one launch made inside it and not the one made just
    before it (pads of launches outside any span around them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    n = 200
    with trace.activate(None):
        trace.session_spans()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(0)
            for i in range(n):
                torch.cuda._sleep(0)
                with trace.span("probe", i=i):
                    torch.cuda._sleep(0)
            for _ in range(1024):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        spans = trace.session_spans()
    assert [sp.attrs["i"] for sp in spans] == list(range(n))
    calls = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CPU
                   and ev.name() == "cudaLaunchKernel")
    held = [[c for c in calls if sp.t0 <= c[0] and c[1] <= sp.t1]
            for sp in spans]
    assert [len(h) for h in held] == [1] * n
    between = [c for c in calls if spans[0].t0 <= c[0] <= spans[-1].t1]
    assert len(between) == 2 * n - 1
    print(f"span start to its launch call: "
          f"{min(h[0][0] - sp.t0 for h, sp in zip(held, spans))} ns "
          f"at least; call end to span end: "
          f"{min(sp.t1 - h[0][1] for h, sp in zip(held, spans))} ns")
