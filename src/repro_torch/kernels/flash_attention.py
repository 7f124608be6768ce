"""Forward attention with a float32 softmax, in the model's layout:

    q (B, S_q, H, D), k and v (B, S_k, KV, D), H % KV == 0 -> (B, S_q, H, D)

Query head h attends with kv head h // (H // KV). Scores are
``(q . k) * sm_scale`` (default 1/sqrt(D)) in float32; a key is allowed
when ``k <= q`` (causal) and ``k > q - window`` (window > 0), by index,
and a disallowed score is -1e30 (not -inf), so a row with no allowed key
averages every value, as the JAX package's kernel and reference do. The
output is rounded once into q's dtype. Two implementations:

  * ``flash_attention_cuda``  — the hand-written CUDA kernels replacing
    the JAX package's Pallas ``_flash_kernel``: blockwise online softmax
    over the model's layout. The kernel is chosen once by dtype:
    bfloat16 runs on Hopper's tensor cores (``csrc/flash_attention_tc.cu``:
    TMA loads into a ring of K/V stages from a producer warpgroup,
    ``wgmma`` products with float32 accumulators in one or two consumer
    warpgroups of 64 query rows, the tiles of ``tc_tiles``), float32 on
    the CUDA cores (``csrc/flash_attention.cu``, 64-row query tiles, 4 x 4
    register tiles of float32 FMAs, the loader ``vector_loads`` picks),
    since the tensor cores take float32 only as TF32. Both take the
    padded width of ``padded_head_dim``. A call that fails to build,
    encode its tensor maps or launch raises; neither route stands in for
    the other;
  * ``flash_attention_torch`` — its plain torch version, the whole
    softmax at once as ``reference_attention`` computes it, with the
    window mask and the grouping added.

``repro_torch.kernels.ops.flash_attention`` routes by the tensors'
device: the plain version for CPU tensors, the kernel for CUDA tensors
(or it raises). ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

#: kernel launches made by ``flash_attention_cuda`` in this process
LAUNCHES = 0

#: dtype -> (source under ``csrc/``, C entry point)
ROUTES = {torch.float32: ("flash_attention", "flash_attention_f32_launch"),
          torch.bfloat16: ("flash_attention_tc",
                           "flash_attention_bf16_launch")}
#: padded head widths both kernels are instantiated for
HEAD_DIM_BUCKETS = (64, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 2)   # head_dim_pad; vec16 (float32) or
                                     # query rows a block (bf16)


class TcTiles(NamedTuple):
    """One instance of the bf16 kernel (``Cfg`` in its source)."""
    width: int          # padded head width
    q_rows: int         # query rows a block: 64 a consumer warpgroup
    k_rows: int         # keys a K/V tile
    stages: int         # depth of the K/V ring
    threads: int        # a producer warpgroup and the consumers
    smem_bytes: int     # dynamic shared memory a block
    regs: tuple         # registers a thread: (producer, consumer)


#: SMs of the H100 the bf16 kernel's pick is made for
SM_COUNT = 132


def _tc_instance(width: int, q_rows: int) -> TcTiles:
    k_rows = 64 if width == 256 else 128
    stages = 3 if width == 64 else 2
    consumers = q_rows // 64
    threads = 128 * (consumers + 1)
    tiles = 2 * width * (q_rows + 2 * stages * k_rows)  # q, K and V rings
    # 1024 bytes to align the tiles to the swizzle's period, then the
    # barriers: a full for each consumer's q tile, a full and an empty
    # for K and V a stage
    smem = tiles + 1024 + 8 * (consumers + 4 * stages)
    # two consumers: setmaxnreg moves registers from the producer (24) to
    # the consumers (240) within the block's launch share, 168 a thread;
    # one consumer keeps the launch share, up to 255, for all
    regs = (24, 240) if consumers == 2 else (255, 255)
    return TcTiles(width, q_rows, k_rows, stages, threads, smem, regs)


#: (padded width, query rows a block) -> the instance the kernel builds
TC_TILES = {(w, rows): _tc_instance(w, rows)
            for w in HEAD_DIM_BUCKETS for rows in (64, 128)}


def tc_tiles(B: int, S_q: int, H: int, D: int) -> TcTiles:
    """The bf16 kernel's instance for q (B, S_q, H, D), by shape alone:
    blocks of 128 query rows (two consumer warpgroups), unless those
    would not give each of the card's SMs a block; then 64 rows (one)."""
    width = padded_head_dim(D)
    rows = 128 if -(-S_q // 128) * B * H >= SM_COUNT else 64
    return TC_TILES[(width, rows)]


#: C entry points resolved so far, by dtype
_FNS: dict = {}


def allowed(S_q: int, S_k: int, causal: bool, window: int,
            device=None) -> torch.Tensor:
    """(S_q, S_k) bool: which (query, key) index pairs attend."""
    qi = torch.arange(S_q, device=device)[:, None]
    kj = torch.arange(S_k, device=device)[None, :]
    ok = torch.ones((S_q, S_k), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= kj > qi - window
    return ok


def padded_head_dim(D: int) -> int:
    """The kernels' width for head_dim D: the smallest bucket that holds
    it; the padded columns are zero-filled."""
    for width in HEAD_DIM_BUCKETS:
        if 1 <= D <= width:
            return width
    raise ValueError(f"head_dim must be in 1..{HEAD_DIM_BUCKETS[-1]}, "
                     f"got {D}")


def vector_loads(D: int, *tensors: torch.Tensor) -> bool:
    """Whether a row of D values (8 bf16 or 4 float32 to 16 bytes) is a
    whole number of 16 bytes and every tensor's first element is 16-byte
    aligned. The float32 kernel then moves rows in 16-byte copies (else it
    loads element by element); the bf16 kernel's TMA maps then address
    the tensors as they lie (else the wrapper stages them)."""
    return D * tensors[0].element_size() % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B,S_q,H,D) and k, v "
                         f"(B,S_k,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S_q, H, D = q.shape
    _, S_k, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not pair (batch, head_dim, H % KV == 0)")
    return B, S_q, S_k, H, KV, D


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain torch version: (B, S_q, H, D) in q's dtype."""
    B, S_q, S_k, H, KV, D = _shapes(q, k, v)
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S_q, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * sm_scale
    s = torch.where(allowed(S_q, S_k, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, S_q, H, D).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the output without
    synchronizing."""
    global LAUNCHES
    B, S_q, S_k, H, KV, D = _shapes(q, k, v)
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"the CUDA kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if D > MAX_HEAD_DIM or S_q < 1 or S_k < 1 or B * H > 65535:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM}, "
                         f"S >= 1 and B*H <= 65535, got {tuple(q.shape)} "
                         f"against {S_k} keys")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16:
        o = _tc_launch(q, k, v, causal, window, sm_scale)
    else:
        o = torch.empty_like(q)
        _launch(q, k, v, o, D, causal, window, sm_scale, padded_head_dim(D),
                int(vector_loads(D, q, k, v, o)))
    LAUNCHES += 1
    return o


def _launch(q, k, v, o, D, causal, window, sm_scale, width, last):
    B, S_q, H, _ = q.shape
    S_k, KV = k.shape[1], k.shape[2]
    status = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S_q, S_k, H, KV, D, sm_scale, int(causal),
        min(int(window), 2**31 - 1), _build.stream_of(q), width, last)
    _build.check(status, f"flash_attention kernel ({ROUTES[q.dtype][0]})")


def _tc_launch(q, k, v, causal, window, sm_scale) -> torch.Tensor:
    """The bf16 kernel on q, k, v. Its TMA maps need 16-byte aligned bases
    and rows of a whole number of 16 bytes: inputs with D % 8 != 0, or
    with any base off a 16-byte boundary, are first copied into
    zero-padded buffers of the bucket's width (and the output read back
    from one); no model path does that. It is the same kernel either
    way."""
    B, S_q, H, D = q.shape
    tiles = tc_tiles(B, S_q, H, D)
    if vector_loads(D, q, k, v):
        o = torch.empty_like(q)
        _launch(q, k, v, o, D, causal, window, sm_scale, tiles.width,
                tiles.q_rows)
        return o
    width = tiles.width
    qp, kp, vp = (_staged(t, width) for t in (q, k, v))
    op = torch.empty_like(qp)
    _launch(qp, kp, vp, op, width, causal, window, sm_scale, width,
            tiles.q_rows)
    return op[..., :D].contiguous()


def _staged(t: torch.Tensor, width: int) -> torch.Tensor:
    """A new zero-filled (..., width) tensor holding ``t`` in its first
    columns."""
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out


def _entry(dtype: torch.dtype):
    """The C entry point of ``dtype``'s kernel, resolved once; raises if
    its source does not build or load."""
    fn = _FNS.get(dtype)
    if fn is None:
        source, symbol = ROUTES[dtype]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn
