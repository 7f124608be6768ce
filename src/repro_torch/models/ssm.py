"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) mixer.

The port of the JAX package's ``models/ssm.py``. Prefill uses the chunked
SSD algorithm: quadratic attention-like compute inside fixed-size chunks,
a linear recurrence across chunk boundaries (the reference's
``lax.scan``, here a loop over the chunks). Decode is the O(1) recurrent
step on a persistent (B, heads, head_dim, state) float32 tensor.

Shapes follow the Mamba-2 conventions:
    d_inner = expand * d_model, heads H = d_inner / head_dim P,
    B/C are per-group (n_groups G) with state size N.

The reference's numerics are kept point for point: ``dt = softplus(dt_raw
+ dt_bias)`` and ``A = -exp(A_log)`` in float32 (``A_log``, ``D`` and
``dt_bias`` are float32 params, never cast), x, B and C cast to float32
before the SSD, ``y + D x`` in float32 and then cast to the compute dtype
before the gated norm. The segment sums are the reference's cumsum
difference with -inf above the diagonal. The SSD reaches no kernel: the
reference computes it in jnp einsums too. Each of the reference's
four-operand einsums is written as pairwise products contracted left to
right, so no (b, chunks, H, c, c, P) intermediate is formed.

A cache is {"state": (B, H, P, N) float32, "conv": (B, W-1, C) compute
dtype}, updated IN PLACE, as the attention caches are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import RMSNorm, _param

SSMCache = Dict[str, torch.Tensor]


class SSM(nn.Module):
    """Params, named as the reference's ``init_ssm`` tree: ``conv_w`` (W,
    C), ``conv_b`` (C,), ``A_log``, ``D``, ``dt_bias`` (H,) float32,
    ``norm.scale`` (d_inner,), ``w_out`` (d_inner, d), and the fused
    ``w_in`` (d, 2 d_inner + 2 G N + H) or, with
    ``cfg.ssm_split_in_proj``, ``w_z``, ``w_x``, ``w_B``, ``w_C``,
    ``w_dt``. C = d_inner + 2 G N is the conv's channel count."""

    #: params ``init_params_`` fills with a constant, as ``init_ssm`` does
    constant_init = {"conv_b": 0.0, "A_log": 0.0, "D": 1.0, "dt_bias": 0.0}

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        di = s.d_inner(d)
        H = s.num_heads(d)
        GN = s.n_groups * s.state_dim
        dt = cfg.dtype("param")
        f32 = torch.float32
        conv_ch = di + 2 * GN
        self.conv_w = _param((s.conv_width, conv_ch), dt, device)
        self.conv_b = _param((conv_ch,), dt, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.norm = RMSNorm(di, dt, device)
        self.w_out = _param((di, d), dt, device)
        if cfg.ssm_split_in_proj:
            self.w_z = _param((d, di), dt, device)
            self.w_x = _param((d, di), dt, device)
            self.w_B = _param((d, GN), dt, device)
            self.w_C = _param((d, GN), dt, device)
            self.w_dt = _param((d, H), dt, device)
        else:
            self.w_in = _param((d, 2 * di + 2 * GN + H), dt, device)

    def _in_proj(self, x: torch.Tensor):
        """(z, xBC, dt_raw) in x's dtype."""
        if self.cfg.ssm_split_in_proj:
            z = x @ self.w_z.to(x.dtype)
            xBC = torch.cat([x @ self.w_x.to(x.dtype),
                             x @ self.w_B.to(x.dtype),
                             x @ self.w_C.to(x.dtype)], dim=-1)
            return z, xBC, x @ self.w_dt.to(x.dtype)
        return _split_proj(self.cfg, x @ self.w_in.to(x.dtype))

    def forward(self, x: torch.Tensor, cache: Optional[SSMCache] = None,
                chunk: int = 256
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
        """x (B, S, d) -> (B, S, d). With a cache and S == 1 the recurrent
        step; otherwise the chunked SSD (chunks of min(chunk, S), which
        must divide S), starting from the cached state where there is a
        cache. The cache's state and conv rows are updated in place."""
        s = self.cfg.ssm
        d = self.cfg.d_model
        di = s.d_inner(d)
        G, N, P = s.n_groups, s.state_dim, s.head_dim
        H = s.num_heads(d)
        B_, S, _ = x.shape
        z, xBC, dt_raw = self._in_proj(x)
        conv_w = self.conv_w.to(x.dtype)
        conv_b = self.conv_b.to(x.dtype)
        if cache is not None:
            new_conv = torch.cat([cache["conv"], xBC],
                                 dim=1)[:, -(s.conv_width - 1):]
            xBC = _causal_conv(xBC, conv_w, conv_b, cache["conv"])
            cache["conv"].copy_(new_conv)
        else:
            xBC = _causal_conv(xBC, conv_w, conv_b)

        xs = xBC[..., :di].reshape(B_, S, H, P)
        Bmat = xBC[..., di:di + G * N].reshape(B_, S, G, N)
        Cmat = xBC[..., di + G * N:].reshape(B_, S, G, N)
        dt = F.softplus(dt_raw.to(torch.float32) + self.dt_bias)   # (B,S,H)
        A = -torch.exp(self.A_log)                                  # (H,)

        if cache is not None and S == 1:
            y = _recurrent_step(cache, xs, dt, A, Bmat, Cmat)
        else:
            init_state = cache["state"] if cache is not None else None
            y, final_state = ssd_chunked(
                xs.to(torch.float32), dt, A, Bmat.to(torch.float32),
                Cmat.to(torch.float32), chunk=min(chunk, S),
                initial_state=init_state)
            if cache is not None:
                cache["state"].copy_(final_state)

        y = y + self.D[None, None, :, None] * xs.to(torch.float32)
        y = y.reshape(B_, S, di).to(x.dtype)
        y = self.norm(y * F.silu(z))
        return y @ self.w_out.to(x.dtype), cache


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype,
                   device=None) -> SSMCache:
    s = cfg.ssm
    d = cfg.d_model
    H = s.num_heads(d)
    conv_ch = s.d_inner(d) + 2 * s.n_groups * s.state_dim
    return {
        "state": torch.zeros((batch, H, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    """The fused projection split into (z, xBC, dt_raw)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    GN = s.n_groups * s.state_dim
    H = s.num_heads(d)
    z = proj[..., :di]
    xBC = proj[..., di:2 * di + 2 * GN]
    dt = proj[..., 2 * di + 2 * GN:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj width {proj.shape[-1]} leaves "
                         f"{dt.shape[-1]} dt channels for {H} heads")
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d, then silu. xBC: (B, S, C); conv_w: (W, C);
    conv_state: (B, W-1, C) trailing context from previous tokens (zeros
    where None). The taps are summed in the reference's order."""
    W = conv_w.shape[0]
    S = xBC.shape[1]
    if conv_state is not None:
        xfull = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    else:
        xfull = F.pad(xBC, (0, 0, W - 1, 0))
    out = xfull[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + xfull[:, i:i + S] * conv_w[i]
    return F.silu(out + conv_b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """log-space segment sums: out[..., i, j] = sum_{j < k <= i} x[..., k]
    as the reference computes it (a cumsum difference), -inf above the
    diagonal."""
    S = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x: (b, S, H, P); dt: (b, S, H); A: (H,); B, C: (b, S, G, N).
    Returns y: (b, S, H, P) and the final state (b, H, P, N). Raises
    ``ValueError`` unless ``chunk`` divides S (the reference asserts it)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = S // chunk
    rep = H // G
    # broadcast groups to heads
    Bc = torch.repeat_interleave(B, rep, dim=2).reshape(b, nc, chunk, H, N)
    Cc = torch.repeat_interleave(C, rep, dim=2).reshape(b, nc, chunk, H, N)
    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)

    dA = dtc * A                                        # (b, nc, c, H)
    dA_cum = torch.cumsum(dA, dim=2)

    # ---- intra-chunk (quadratic in chunk) ----
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (b, nc, H, c, c)
    # "bnihN,bnjhN->bnhij"
    scores = Cc.permute(0, 1, 3, 2, 4) @ Bc.permute(0, 1, 3, 4, 2)
    # "bnhij,bnhij,bnjh,bnjhp->bnihp", left to right
    w = scores * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = (w @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # ---- chunk states ----
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)    # (b,nc,c,H)
    # "bnchN,bnch,bnch,bnchp->bnhpN", left to right
    Bw = Bc * decay_states[..., None] * dtc[..., None]          # (b,nc,c,H,N)
    states = xc.permute(0, 1, 3, 4, 2) @ Bw.permute(0, 1, 3, 2, 4)

    # ---- inter-chunk recurrence (the reference's scan over chunks) ----
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b, nc, H)
    carry = (torch.zeros_like(states[:, 0]) if initial_state is None
             else initial_state.reshape(b, H, P, N))
    prev = []
    for n in range(nc):
        prev.append(carry)                              # state BEFORE chunk
        carry = carry * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                      # (b,nc,H,P,N)

    # ---- contribution of previous-chunk state to outputs ----
    state_decay = torch.exp(dA_cum)                             # (b,nc,c,H)
    # "bnchN,bnhpN,bnch->bnchp", left to right
    y_off = (Cc.permute(0, 1, 3, 2, 4) @ prev_states.transpose(-1, -2))
    y_off = y_off.permute(0, 1, 3, 2, 4) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, carry


def _recurrent_step(cache: SSMCache, xs, dt, A, Bmat, Cmat) -> torch.Tensor:
    """The decode step: the cached state decays by exp(dt A) and takes
    dt x B^T; y = state C. Updates ``cache["state"]`` in place; returns
    y (B, 1, H, P) float32."""
    H = xs.shape[2]
    rep = H // Bmat.shape[2]
    Bh = torch.repeat_interleave(Bmat, rep, dim=2)[:, 0].to(torch.float32)
    Ch = torch.repeat_interleave(Cmat, rep, dim=2)[:, 0].to(torch.float32)
    dt0 = dt[:, 0]                                              # (B, H)
    dA = torch.exp(dt0 * A)
    xt = xs[:, 0].to(torch.float32)                             # (B, H, P)
    # "bh,bhp,bhn->bhpn", left to right
    upd = (dt0[..., None] * xt)[..., None] * Bh[:, :, None, :]
    state = cache["state"] * dA[..., None, None] + upd
    cache["state"].copy_(state)
    y = (state @ Ch[..., None])[..., 0]                         # "bhpn,bhn->bhp"
    return y[:, None]
