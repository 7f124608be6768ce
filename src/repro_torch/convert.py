"""Carry scheduler state and model weights into the port from plain data.

The port imports nothing of the JAX package, so state crosses as plain
Python and numpy data: ``dataclasses.asdict`` of a job, a list of
per-machine capacity dicts plus the host ledger, a dict of price
parameters, a model's param tree as nested dicts of numpy arrays (or
tensors, as a checkpoint loads them), and back as nested dicts of CPU
tensors (``*_params_to_jax``, what the trainer checkpoints). The tests
use these to hand both packages the same jobs, the same mid-run ledger
and the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from .backend import get_backend
from .backend.torch_backend import resolve_device
from .core.cluster import Cluster, Machine
from .core.job import ElasticProfile, JobSpec, QualityCurve, SigmoidUtility
from .core.pricing import PriceParams
from .models.encdec import EncDec
from .models.lm import LM


def job_from_record(rec: Mapping) -> JobSpec:
    """A ``JobSpec`` from the ``dataclasses.asdict`` of one, including its
    ``SigmoidUtility`` and any ``ElasticProfile``."""
    rec = dict(rec)
    rec["utility"] = SigmoidUtility(**rec["utility"])
    rec["worker_demand"] = dict(rec["worker_demand"])
    rec["ps_demand"] = dict(rec["ps_demand"])
    el = rec.get("elastic")
    if el is not None:
        el = dict(el)
        el["levels"] = tuple(el["levels"])
        if el.get("curve") is not None:
            el["curve"] = QualityCurve(**el["curve"])
        rec["elastic"] = ElasticProfile(**el)
    return JobSpec(**rec)


def jobs_from_records(records: List[Mapping]) -> List[JobSpec]:
    return [job_from_record(r) for r in records]


def cluster_from_arrays(capacities: List[Dict[str, float]], horizon: int,
                        used: np.ndarray, device=None) -> Cluster:
    """A cluster with one machine per capacity dict whose ledger is
    ``used`` (T, H, R on the sorted resource axis), placed on ``device``
    (None = the CUDA card). The version is bumped past construction so
    no cache built before the handover can be mistaken for current."""
    machines = [Machine(h, dict(cap)) for h, cap in enumerate(capacities)]
    cl = Cluster(machines=machines, horizon=horizon,
                 backend=get_backend(None, device))
    used = np.asarray(used, dtype=np.float64)
    if used.shape != tuple(cl._used.shape):
        raise ValueError(f"ledger shape {used.shape} != "
                         f"{tuple(cl._used.shape)}")
    cl._used.copy_(torch.from_numpy(used))
    cl.version += 1
    cl._slot_versions[:] = cl.version
    return cl


def price_params_from_dict(d: Mapping) -> PriceParams:
    """``PriceParams`` from ``{"U": {resource: U^r}, "L": L, "mu": mu}``."""
    return PriceParams(U=dict(d["U"]), L=float(d["L"]), mu=float(d["mu"]))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Leaves by dotted name; torch tensors stay tensors, anything else
    becomes a numpy array."""
    out: Dict[str, object] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val if isinstance(val, torch.Tensor) \
                else np.asarray(val)
    return out


def _tensor(arr) -> torch.Tensor:
    """``arr`` as a torch tensor (one already, as
    ``checkpoint.load_checkpoint`` gives, stays as it is; a numpy array is
    copied); numpy's bfloat16 (ml_dtypes, as ``np.asarray`` of a bf16 jax
    array gives) crosses by its bits."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unstack(tree: Mapping, stacks: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The flattened tree with each array under a stacked prefix (``name``
    -> its layer count) split along its leading L axis into
    ``{prefix}.{i}.<rest>``."""
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        prefix = name.split(".", 1)[0]
        if prefix in stacks and "." in name:
            rest = name[len(prefix) + 1:]
            if arr.shape[0] != stacks[prefix]:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"{stacks[prefix]} layers")
            for i in range(stacks[prefix]):
                state[f"{prefix}.{i}.{rest}"] = _tensor(arr[i])
        else:
            state[name] = _tensor(arr)
    return state


def _restack(params, stacks: Dict[str, int]) -> Dict:
    """The inverse of ``_unstack``: ``params``' tensors as a nested dict
    by the dotted names, each ``{prefix}.{i}.<rest>`` of a stacked prefix
    gathered into ``<rest>`` under ``prefix`` with layer i on a leading
    axis; detached CPU tensors, in the param dtype."""
    state = {name: t.detach().cpu() for name, t in params.state_dict().items()}
    flat: Dict[str, torch.Tensor] = {}
    for prefix, layers in stacks.items():
        rests = sorted({name.split(".", 2)[2] for name in state
                        if name.startswith(prefix + ".")})
        for rest in rests:
            flat[f"{prefix}.{rest}"] = torch.stack(
                [state.pop(f"{prefix}.{i}.{rest}") for i in range(layers)])
    flat.update(state)
    tree: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def lm_params_to_jax(cfg, params) -> Dict:
    """The JAX package's ``lm.init`` tree of the port's ``LM`` params, the
    inverse of ``lm_params_from_jax``: nested dicts of CPU tensors (bf16
    params stay bf16), every ``layers.{i}.<name>`` stacked on a leading L
    axis as ``layers/<name>``. ``checkpoint.save_checkpoint`` writes it
    in the reference's layout."""
    return _restack(params, {"layers": cfg.num_layers})


def encdec_params_to_jax(cfg, params) -> Dict:
    """The JAX package's ``encdec.init`` tree of the port's ``EncDec``
    params (``encoder`` and ``decoder`` stacked), the inverse of
    ``encdec_params_from_jax``."""
    return _restack(params, {"encoder": cfg.encoder_layers,
                             "decoder": cfg.num_layers})


def lm_params_from_jax(cfg, tree: Mapping, device=None):
    """The port's ``LM`` params from the JAX package's ``lm.init`` tree
    (nested dicts of numpy arrays): ``embed/table``, ``unembed/table``,
    ``final_norm/scale`` and ``layers/...`` stacked on a leading L axis
    (``attn_norm/scale``, ``attn/{wq,wk,wv,wo,q_norm,k_norm}`` or for MLA
    ``attn/{w_dq,q_norm/scale,w_uq,w_dkv,kv_norm/scale,w_uk,w_uv,wo}``,
    ``ffn_norm/scale``, ``mlp/{w_gate,w_up,w_down}``, or for MoE
    ``moe/{router,w_gate,w_up,w_down}`` with the expert axis second and
    ``moe/shared/{w_gate,w_up,w_down}``; for the SSM ``ssm_norm/scale``
    and ``ssm/{conv_w,conv_b,A_log,D,dt_bias,norm/scale,w_out}`` with
    ``w_in`` or ``w_z/w_x/w_B/w_C/w_dt``; a hybrid's attention and SSM
    leaves and ``attn_out_norm/scale``, ``ssm_out_norm/scale``), and for
    the vision frontend ``projector/{w1,w2}``. The port's modules keep
    the tree's names and per-layer layouts, so layer i of every stacked
    array becomes ``layers.{i}.<name>``. Every array is copied into the
    param of that name (the config's param dtype, bf16 included; the
    router and the SSM's ``A_log``, ``D``, ``dt_bias`` float32); missing
    or extra names raise."""
    params = LM(cfg, device=resolve_device(device))
    params.load_state_dict(_unstack(tree, {"layers": cfg.num_layers}),
                           strict=True)
    return params


def encdec_params_from_jax(cfg, tree: Mapping, device=None):
    """The port's ``EncDec`` params from the JAX package's ``encdec.init``
    tree: ``embed/table``, ``frontend_proj/w``, ``encoder/...`` stacked
    on ``cfg.encoder_layers``, ``enc_norm/scale``, ``decoder/...``
    stacked on ``cfg.num_layers`` (with ``cross_norm/scale`` and
    ``cross_attn/{wq,wk,wv,wo}``), ``final_norm/scale`` and
    ``unembed/table``; as ``lm_params_from_jax``, missing or extra names
    raise."""
    params = EncDec(cfg, device=resolve_device(device))
    params.load_state_dict(_unstack(tree, {"encoder": cfg.encoder_layers,
                                           "decoder": cfg.num_layers}),
                           strict=True)
    return params
