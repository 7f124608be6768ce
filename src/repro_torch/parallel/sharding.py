"""Sharding rules: map every param / batch / cache tensor to a spec, and a
spec to DTensor placements on a ``DeviceMesh``.

The port of the JAX package's ``parallel/sharding.py``. The rule table,
the serve overrides, the refuted experts-on-data table, ``MeshRules``
and its resolution are the reference's, copied:

  * "tensor" dims (attention heads, FFN hidden, experts, vocab) shard on
    the ``model`` axis;
  * the d_model ("embed") dim shards on the ``data`` axis (FSDP-style), so
    per-device param+optimizer bytes scale 1/(data*model);
  * the ``pod`` axis (multi-pod mesh) replicates params by default —
    pods are data-parallel replicas whose gradients sync over the slow
    link. ``fsdp_over_pod=True`` shards d_model over (pod, data) instead;
  * any rule whose dim is not divisible by the axis size falls back to a
    prefix of its axes, then to replication for that dim (e.g.
    kv_heads=8 on a 16-way model axis);
  * one mesh axis appears at most once in a spec.

A **spec** is a tuple with one entry per tensor dim: None, an axis name,
or a tuple of axis names (major to minor), the counterpart of a
``PartitionSpec``. ``MeshRules`` reads only a mesh's axis names and their
sizes, so it takes a ``torch.distributed.DeviceMesh`` or a shape-only
``MeshShape``: specs need no process group.

Paths. The reference matches its rules on the stacked tree's paths
(``layers/attn/wq``, shape (L, d, H, hd)); the port's params are per
layer (``layers.3.attn.wq``, shape (d, H, hd), as ``convert._unstack``
names them). ``spec_for`` takes either name: a per-layer param gets the
reference's spec of its stacked path without the leading (layer) entry.
``cache_spec`` takes a per-layer cache tensor, batch at dim 0 (the
reference's stacked cache has it at dim 1).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from torch import nn

# (path regex, per-dim logical axes, counted from the END of the shape)
# logical names: "model" | "fsdp" | None; leading dims not listed => None
_PARAM_RULES: List[Tuple[str, Sequence[Optional[str]]]] = [
    # embeddings: (V, d). The vocab dim is NOT sharded: a vocab-sharded
    # table turns the token gather into a full gather of the table — d on
    # fsdp keeps storage bounded instead.
    (r"(^|/)embed/table$", (None, "fsdp")),
    (r"(^|/)unembed/table$", ("model", "fsdp")),
    # attention (L, d, H, hd) / (L, H, hd, d)
    (r"/attn/wq$", ("fsdp", "model", None)),
    (r"/attn/wk$", ("fsdp", "model", None)),
    (r"/attn/wv$", ("fsdp", "model", None)),
    (r"/attn/wo$", ("model", None, "fsdp")),
    (r"/cross_attn/wq$", ("fsdp", "model", None)),
    (r"/cross_attn/wk$", ("fsdp", "model", None)),
    (r"/cross_attn/wv$", ("fsdp", "model", None)),
    (r"/cross_attn/wo$", ("model", None, "fsdp")),
    # MLA ("model2" resolves only on a re-factorized (data, model, model2)
    # mesh; on the canonical mesh it replicates)
    (r"/attn/w_dq$", ("fsdp", "model2")),
    (r"/attn/w_uq$", ("model2", "model", None)),
    (r"/attn/w_dkv$", ("fsdp", None)),
    (r"/attn/w_uk$", ("model2", "model", None)),
    (r"/attn/w_uv$", ("model2", "model", None)),
    # dense mlp (L, d, ff) / (L, ff, d)
    (r"/mlp/w_gate$", ("fsdp", "model")),
    (r"/mlp/w_up$", ("fsdp", "model")),
    (r"/mlp/w_down$", ("model", "fsdp")),
    # moe (L, E, d, ff) / (L, E, ff, d); router (L, d, E): experts shard
    # on the MODEL axis (expert parallelism) with d_model on fsdp
    (r"/moe/router$", (None, None)),
    (r"/moe/w_gate$", ("model", "fsdp", None)),
    (r"/moe/w_up$", ("model", "fsdp", None)),
    (r"/moe/w_down$", ("model", None, "fsdp")),
    (r"/moe/shared/w_gate$", ("fsdp", "model")),
    (r"/moe/shared/w_up$", ("fsdp", "model")),
    (r"/moe/shared/w_down$", ("model", "fsdp")),
    # ssm
    (r"/ssm/w_in$", ("fsdp", None)),
    (r"/ssm/w_z$", ("fsdp", "model")),
    (r"/ssm/w_x$", ("fsdp", "model")),
    (r"/ssm/w_B$", ("fsdp", None)),
    (r"/ssm/w_C$", ("fsdp", None)),
    (r"/ssm/w_dt$", ("fsdp", "model")),
    (r"/ssm/w_out$", ("model", "fsdp")),
    # projector / frontend
    (r"projector/w1$", ("fsdp", "model")),
    (r"projector/w2$", ("model", "fsdp")),
    (r"frontend_proj/w$", ("fsdp", None)),
]

# serve-time (decode) rule overrides. Empty: the expert layout is the
# same for train and decode; the mechanism stays for workload-dependent
# layouts.
_SERVE_OVERRIDES: List[Tuple[str, Sequence[Optional[str]]]] = []

# the refuted experts-on-data layout (MeshRules.moe_experts_on = "data")
_MOE_ON_DATA: List[Tuple[str, Sequence[Optional[str]]]] = [
    (r"/moe/w_gate$", ("fsdp", None, "model")),
    (r"/moe/w_up$", ("fsdp", None, "model")),
    (r"/moe/w_down$", ("fsdp", "model", None)),
]

#: the port's stacks of per-layer params: ``{prefix}.{i}.<rest>``
STACKS = ("layers", "encoder", "decoder")

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: enough for
    ``MeshRules`` (the counterpart of ``jax.sharding.AbstractMesh``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _match_rule(path: str, serve: bool = False):
    if serve:
        for pat, axes in _SERVE_OVERRIDES:
            if re.search(pat, path):
                return axes
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            return axes
    return None


def ref_path(name: str) -> Tuple[str, bool]:
    """(the reference's path, whether the param is one layer of a stack)
    for a port param name: ``layers.3.attn.wq`` -> ("layers/attn/wq",
    True), ``embed.table`` -> ("embed/table", False). A name already in
    the reference's form is returned as it is (not per layer)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKS and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


class MeshRules:
    """Resolve logical axis names against a mesh's axis sizes."""

    def __init__(self, mesh, fsdp_over_pod: bool = False,
                 tp_over_pod: bool = False, pure_fsdp: bool = False):
        """tp_over_pod: tensor-parallel axes span pods, so per-layer
        activation collectives cross the slow link (the locality-oblivious
        variant). pure_fsdp: no tensor parallelism — batch and weight
        shards span (data, model) jointly; per-layer weight all-gathers
        replace the tensor-parallel activation all-reduces."""
        self.moe_experts_on = "model"
        self.mesh = mesh
        self.sizes = mesh_axes(mesh)
        names = tuple(self.sizes)
        intra = tuple(a for a in ("data", "model") if a in names)
        if pure_fsdp:
            self.model_axes: Tuple[str, ...] = ()
            self.fsdp_axes: Tuple[str, ...] = intra
            self.batch_axes: Tuple[str, ...] = (
                ("pod",) + intra if "pod" in names else intra)
            self.model2_axes: Tuple[str, ...] = ()
            return
        if "pod" in names and tp_over_pod:
            self.model_axes = ("pod", "model")
        else:
            self.model_axes = ("model",) if "model" in names else ()
        self.model2_axes = ("model2",) if "model2" in names else ()
        if "pod" in names and fsdp_over_pod and not tp_over_pod:
            self.fsdp_axes = ("pod", "data")
        elif "data" in names:
            self.fsdp_axes = ("data",)
        else:
            self.fsdp_axes = ()
        if "pod" in names and not fsdp_over_pod and not tp_over_pod:
            self.batch_axes = ("pod", "data")
        elif "data" in names:
            self.batch_axes = ("data",)
        else:
            self.batch_axes = ()

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def _resolve(self, logical: Optional[str], dim: int) -> Entry:
        if logical == "model":
            axes = self.model_axes
        elif logical == "model2":
            axes = self.model2_axes
        elif logical == "fsdp":
            axes = self.fsdp_axes
        elif logical == "batch":
            axes = self.batch_axes
        else:
            return None
        if not axes:
            return None
        if dim % self.axis_size(axes) != 0:
            # fall back: try a prefix of the axes tuple
            for k in range(len(axes) - 1, 0, -1):
                sub = axes[:k]
                if dim % self.axis_size(sub) == 0:
                    return sub if len(sub) > 1 else sub[0]
            return None
        return axes if len(axes) > 1 else axes[0]

    def _stacked_spec(self, path: str, shape: Tuple[int, ...],
                      serve: bool) -> Spec:
        """The reference's ``spec_for`` on its own path and shape."""
        axes = None
        if self.moe_experts_on == "data":
            for pat, a in _MOE_ON_DATA:
                if re.search(pat, path):
                    axes = a
                    break
        if axes is None:
            axes = _match_rule(path, serve=serve)
        if axes is None:
            return ()
        lead = len(shape) - len(axes)
        if lead < 0:
            return ()
        entries: List[Entry] = [None] * lead
        used = set()
        for logical, dim in zip(axes, shape[lead:]):
            r = self._resolve(logical, dim)
            # one mesh axis may appear at most once in a spec
            key = tuple(r) if isinstance(r, tuple) else (r,)
            if r is not None and not (set(key) & used):
                entries.append(r)
                used.update(key)
            else:
                entries.append(None)
        return tuple(entries)

    def spec_for(self, name: str, shape: Tuple[int, ...],
                 serve: bool = False) -> Spec:
        """The spec of param ``name`` (the port's dotted name, or the
        reference's path) of ``shape``; () replicates (``P()``)."""
        path, per_layer = ref_path(name)
        if not per_layer:
            return self._stacked_spec(path, tuple(shape), serve)
        spec = self._stacked_spec(path, (1,) + tuple(shape), serve)
        return spec[1:]

    # ------------------------------------------------------------------
    def batch_spec(self, shape: Tuple[int, ...]) -> Spec:
        b = self._resolve("batch", shape[0])
        return (b,) + (None,) * (len(shape) - 1)

    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """A per-layer decode cache tensor (B, ...): batch on data, the
        largest trailing dim that the model axes divide on model (the
        reference's stacked (L, B, ...) rule without its L)."""
        if len(shape) < 1:
            return ()
        entries: List[Entry] = [None] * len(shape)
        entries[0] = self._resolve("batch", shape[0])
        best, best_dim = None, 0
        for i in range(1, len(shape)):
            r = self._resolve("model", shape[i])
            if r is not None and shape[i] > best_dim:
                best, best_dim = i, shape[i]
        if best is not None:
            entries[best] = self._resolve("model", shape[best])
        return tuple(entries)


# ---------------------------------------------------------------- placements
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on every mesh dim that spec entry d names, ``Replicate``
    on the rest. An entry of several axes shards dim d on each, in mesh
    order, which is the spec's major-to-minor order (a spec naming them
    in another order raises). A mesh dim of size 1 holds the whole
    tensor either way, and gets ``Replicate``: DTensor's view rules treat
    a shard over one device as a shard."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _named(tree, prefix: str = ""):
    """(dotted name, tensor) of a module's params, or of a nested
    dict / list of tensors; other leaves (host ints) are skipped."""
    if isinstance(tree, nn.Module):
        yield from tree.named_parameters()
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if hasattr(tree, "shape"):
            yield prefix, tree
        return
    for k, v in items:
        yield from _named(v, f"{prefix}.{k}" if prefix else str(k))


def param_shardings(rules: MeshRules, params, serve: bool = False) -> Dict:
    """{param name: placements} for a params module (or a name -> tensor
    dict, as the AdamW moments are)."""
    return {name: placements(rules.spec_for(name, tuple(t.shape), serve),
                             rules.mesh)
            for name, t in _named(params)}


def batch_shardings(rules: MeshRules, batch: Dict) -> Dict:
    return {name: placements(rules.batch_spec(tuple(t.shape)), rules.mesh)
            for name, t in _named(batch)}


def serve_state_spec(rules: MeshRules, path: str, shape) -> Spec:
    """The spec of a serve-state tensor by its dotted path: the reference's
    ``serve_state_shardings`` rule (0-d and positions replicated, the
    encoder output by batch, caches by ``cache_spec``)."""
    if len(shape) == 0 or path.endswith(".positions") or path == "pos" \
            or path.endswith(".pos"):
        return ()
    if path.startswith("enc"):
        return rules.batch_spec(tuple(shape))
    return rules.cache_spec(path, tuple(shape))


def serve_state_shardings(rules: MeshRules, state) -> Dict:
    """{dotted path: placements} of every tensor of a serve state
    (``cache.{i}.attn.k``, ``enc``, ...)."""
    return {path: placements(serve_state_spec(rules, path, t.shape),
                             rules.mesh)
            for path, t in _named(state)}


def replicated(rules: MeshRules, tree) -> Dict:
    return {path: placements((), rules.mesh) for path, _ in _named(tree)}
