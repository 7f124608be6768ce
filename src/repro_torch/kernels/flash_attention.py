"""Forward attention with a float32 softmax, in the model's layout:

    q (B, S_q, H, D), k and v (B, S_k, KV, D), H % KV == 0 -> (B, S_q, H, D)

Query head h attends with kv head h // (H // KV). Scores are
``(q . k) * sm_scale`` (default 1/sqrt(D)) in float32; a key is allowed
when ``k <= q`` (causal) and ``k > q - window`` (window > 0), by index,
and a disallowed score is -1e30 (not -inf), so a row with no allowed key
averages every value, as the JAX package's kernel and reference do. The
output is rounded once into q's dtype. Two implementations:

  * ``flash_attention_cuda``  — the hand-written CUDA kernels replacing
    the JAX package's Pallas ``_flash_kernel``: blockwise online softmax,
    one block per (64-row query tile, batch*head). The kernel is chosen
    once by dtype: bfloat16 runs on the tensor cores
    (``csrc/flash_attention_tc.cu``, bf16 ``mma.sync`` products with
    float32 accumulators), float32 on the CUDA cores
    (``csrc/flash_attention.cu``, 4 x 4 register tiles of float32 FMAs),
    since the tensor cores take float32 only as TF32. Both take the
    padded width and the loader that ``padded_head_dim`` and
    ``vector_loads`` choose. A call that fails to build or launch raises;
    neither route stands in for the other;
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
from typing import Optional

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
             + [ctypes.c_int] * 2)           # head_dim_pad, vec16
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
    """Whether the kernel for the tensors' dtype may move rows in 16-byte
    copies: a row of D values (8 bf16 or 4 float32 to a copy) is a whole
    number of 16 bytes and every tensor's first element is 16-byte
    aligned. Otherwise the same kernel loads element by element."""
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
    o = torch.empty_like(q)
    status = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S_q, S_k, H, KV, D, sm_scale, int(causal),
        min(int(window), 2**31 - 1), _build.stream_of(q),
        padded_head_dim(D), int(vector_loads(D, q, k, v, o)))
    _build.check(status, f"flash_attention kernel ({ROUTES[q.dtype][0]})")
    LAUNCHES += 1
    return o


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
