"""Roofline analysis of the dry run's plans, with the H100's constants.

The port of the JAX package's ``roofline/analysis.py``: ``model_flops``,
``hbm_traffic_model``, ``roofline_terms`` and ``roofline_report`` keep
the reference's arithmetic and output keys. Three terms per (arch x
shape x mesh), all in seconds per step:

    compute    = per-device FLOPs / PEAK_FLOPS
    memory     = analytic per-device HBM traffic / HBM_BW
    collective = fast-domain bytes / NVLINK_BW + cross-domain bytes / IB_BW

The constants are one H100 SXM's, from NVIDIA's data sheet (dense bf16,
HBM3, NVLink 4 per direction) and one 400 Gb/s NDR InfiniBand NIC per
GPU. The reference charges a collective to its slow link when its group
crosses a 256-chip TPU pod; on an H100 cluster the fast domain is the
8-GPU NVLink node, so the boundary is ``NVLINK_DOMAIN`` (8), a parameter
of ``collective_bytes``. The keys keep the reference's names:
``intra_pod`` is traffic inside one fast domain, ``cross_pod`` traffic
whose group crosses one.

There is no HLO to parse in torch. ``collective_bytes`` applies the
reference's traffic model (``collective_bytes_from_hlo``) to the
collectives the dry run records: each op's per-device output bytes and
its groups of ranks, from the op's process group and the mesh.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

import numpy as np

# ---- H100 SXM constants (per GPU) ----
PEAK_FLOPS = 989e12        # bf16 tensor cores, dense
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s per direction (NVLink 4, 18 links)
IB_BW = 50e9               # bytes/s (one 400 Gb/s NDR NIC per GPU)
NVLINK_DOMAIN = 8          # GPUs per NVLink node: the fast domain

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


class Collective(NamedTuple):
    """One recorded collective: its kind (one of ``_COLLECTIVES``), its
    per-device output bytes, and its groups of global ranks, one row a
    group."""
    op: str
    out_bytes: int
    groups: np.ndarray


def collective_bytes(records: Iterable[Collective],
                     domain: int = NVLINK_DOMAIN) -> Dict[str, float]:
    """PER-DEVICE collective link traffic, the reference's ring model on
    each op's per-device output bytes:
        all-reduce:         2 x out        (reduce-scatter + all-gather)
        all-gather:         1 x out        (out is the gathered buffer)
        reduce-scatter:     G x out        (the G x out input moves through)
        all-to-all:         1 x out
        collective-permute: 1 x out
    split into ``intra_pod`` and ``cross_pod`` by whether ANY group spans
    a ``domain``-rank boundary."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    out["cross_pod"] = 0.0
    out["intra_pod"] = 0.0
    for rec in records:
        if rec.op not in _COLLECTIVES:
            raise ValueError(f"unknown collective {rec.op!r}")
        groups = np.asarray(rec.groups).reshape(len(rec.groups), -1)
        G = groups.shape[1]
        cross = bool(((groups.max(1) // domain)
                      != (groups.min(1) // domain)).any())
        if rec.op == "all-reduce":
            traffic = 2.0 * rec.out_bytes
        elif rec.op == "reduce-scatter":
            traffic = float(G) * rec.out_bytes
        else:
            traffic = float(rec.out_bytes)
        out[rec.op] += traffic
        out["cross_pod" if cross else "intra_pod"] += traffic
    return {k: v for k, v in out.items() if v > 0}


# ----------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense train) / 2 N D (inference), N = active
    params, D = tokens processed this step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


def hbm_traffic_model(cfg, shape, chips: int) -> float:
    """Analytic per-device HBM traffic (bytes/step) — the fused lower
    bound, what a well-fused executable must move:
      train:   params+grads+2 Adam moments r/w (~6x param bytes) +
               activations (~12 d_model r/w per token-layer with remat)
      prefill: params read + ~6x activation traffic
      decode:  params read + KV/state cache read+write
    """
    pbytes = 2 if cfg.param_dtype == "bfloat16" else 4
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    n_total = cfg.param_count()
    L = cfg.num_layers + cfg.encoder_layers
    d = cfg.d_model

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        param_traffic = n_total * pbytes * 6.0
        act_traffic = tokens * d * L * cbytes * 12.0
        return (param_traffic + act_traffic) / chips

    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return (n_total * pbytes + tokens * d * L * cbytes * 6.0) / chips

    # decode: one token per sequence; whole cache is streamed
    tokens = shape.global_batch
    cache_bytes = 0.0
    if cfg.attention == "mla" and cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        cache_bytes = (shape.global_batch * min(shape.seq_len, 1 << 30)
                       * per_tok * cfg.num_layers * cbytes)
    elif cfg.attention == "gqa":
        win = cfg.long_context_window if shape.name == "long_500k" else None
        s_eff = min(shape.seq_len, win or shape.seq_len)
        per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim()
        cache_bytes = (shape.global_batch * s_eff * per_tok
                       * cfg.num_layers * cbytes)
    if cfg.ssm is not None:
        s = cfg.ssm
        state = (shape.global_batch * s.num_heads(d) * s.head_dim
                 * s.state_dim * 4)
        cache_bytes += state * cfg.num_layers * 2  # read+write
    return (n_total * pbytes + cache_bytes
            + tokens * d * L * cbytes * 6.0) / chips


def roofline_terms(cfg, shape, result: Dict) -> Dict:
    """result: dict from dryrun_one (devices, flops, hlo_bytes,
    collective_bytes)."""
    chips = result["devices"]
    mf = model_flops(cfg, shape)
    flops = result["flops"]
    hbytes = result["hlo_bytes"]
    # the reference detects whole-module reporting (>= 50% of MODEL_FLOPS);
    # the dry run reports the per-device program, which this reads so
    # whenever chips > 1
    per_device = flops < 0.5 * mf
    if not per_device:
        flops = flops / chips
        hbytes = hbytes / chips
    coll = result.get("collective_bytes", {})
    cross = coll.get("cross_pod", 0.0)
    intra = sum(v for k, v in coll.items()
                if k in _COLLECTIVES) - cross
    compute_s = flops / PEAK_FLOPS
    memory_upper_s = hbytes / HBM_BW
    memory_s = hbm_traffic_model(cfg, shape, chips) / HBM_BW
    # collective bytes are already per-device link traffic
    collective_s = intra / NVLINK_BW + cross / IB_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_upper_s": memory_upper_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_frac": mf / chips / max(flops, 1.0),
        "per_device_convention": bool(per_device),
    }


def roofline_report(cfg, shape, result: Dict) -> str:
    t = roofline_terms(cfg, shape, result)
    return (f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
            f"(upper={t['memory_upper_s']:.3e}s) "
            f"collective={t['collective_s']:.3e}s dominant={t['dominant']} "
            f"useful={t['useful_flops_frac']:.2f}")
