"""Multi-pod dry run: plan a step on the production mesh without
allocating anything.

The port of the JAX package's ``launch/dryrun.py``. For an (architecture
x input shape) on a production mesh (``launch.mesh``: 16x16, or 2x16x16
over two pods, built over a fake process group), the step runs ONCE on
meta DTensors placed by the sharding rules (``parallel.MeshRules``):

  * train: ``make_train_step`` over the params and AdamW moments;
  * prefill: ``Model.prefill``; decode: ``Model.decode`` with
    ``decode_window``;

under ``activation_sharding`` (none for decode, as the reference) and
``implicit_replication`` (what the model makes itself — positions, RoPE
tables, masks — is replicated). Meta tensors carry no data, so nothing
is computed and nothing is allocated; DTensor runs each op's local
version on the local shards and emits the collectives its placements
need. A dispatch mode (``_Plan``) sees the program ONE device runs:

  * ``flops``: the per-device FLOPs, counted only on the local shards
    (``torch.utils.flop_counter``'s formulas; the DTensor-level op is
    not counted), so the count is exact: on one device it equals the
    unsharded count, and a split that computes nothing twice divides it;
  * ``hlo_bytes``: the bytes every local op reads and writes, unfused
    (views move none): the counterpart of XLA's "bytes accessed", an
    upper bound on HBM traffic;
  * ``collective_bytes``: each recorded collective's per-device output
    bytes and its rank groups, through ``roofline.collective_bytes``;
  * ``memory``: ``argument_bytes`` (the local shards of the step's
    arguments: params, moments, step and batch, or params and state),
    ``output_bytes`` (of what the step returns), ``peak_bytes`` (the
    most bytes of local storage alive at once, argument storage
    included, tracked by storage lifetimes) and ``temp_bytes`` (peak
    minus arguments).

Weights sharded on the FSDP axes are gathered when a module reads them
(``_GatherOnRead``), as FSDP does; what DTensor cannot split in a
version-independent way runs per shard (``parallel.context``). The
prefill plan traces the flash kernel's plain version (a meta tensor
never reaches a card), so its peak counts the (S_q, S_k) scores that the
kernel never holds. The reference's L = 1 / L = 2 probes (``_extrapolate``)
stay: the port traces every layer, so they are a check: their FLOPs must
equal the direct count, and the largest relative gap of the bytes and
collectives is reported (``extrapolation_gap``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma-7b --shape train_4k [--multi-pod] [--all] \\
        [--fsdp-over-pod] [--out results.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.base import ArchConfig, InputShape
from ..models import build_model, decode_window, input_specs, \
    serve_state_specs
from ..optim import AdamWConfig
from ..parallel import MeshRules, placements
from ..parallel.context import activation_sharding
from ..parallel.sharding import mesh_axes, serve_state_spec
from ..roofline.analysis import Collective, collective_bytes, \
    roofline_report
from ..train import abstract_train_state, make_train_step
from .mesh import fake_world, host_world, make_host_mesh, \
    make_production_mesh, production_shape

#: the functional collectives DTensor emits, by the reference's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: functional ops that move nothing between devices
_LOCAL_FUNCOL = {"wait_tensor", "_wrap_tensor_autograd"}

#: queries of a tensor's metadata, which count nothing (FlopCounterMode
#: skips the same ones)
_META_QUERIES = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}


def mesh_groups(mesh) -> Dict[str, np.ndarray]:
    """{process group name: its groups of global ranks, one row a group}
    for every mesh dim: the groups a collective over that dim runs in."""
    ranks = mesh.mesh.cpu().numpy()
    out = {}
    for k in range(ranks.ndim):
        rows = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
        out[mesh.get_group(k).group_name] = rows
    return out


def _program(tensors) -> bool:
    """Whether an op's tensors are the traced program's: plain meta
    tensors. The sharding propagator works on fake tensors (global
    shapes) and on small host tensors (shard offsets), and runs each only
    the first time it meets an op's placements; none of that is the
    program, and counting it would make the count depend on the cache."""
    from torch._subclasses.fake_tensor import FakeTensor

    return all(t.device.type == "meta" and not isinstance(t, FakeTensor)
               for t in tensors)


class _Plan(TorchDispatchMode):
    """Counts the per-device program of a DTensor trace (module
    docstring): an op on DTensors is handed to DTensor (NotImplemented),
    which runs its local ops and collectives on plain tensors; those are
    counted; the sharding propagator's own work is not (``_program``)."""

    def __init__(self, groups: Dict[str, np.ndarray]):
        super().__init__()
        self.groups = groups
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live = 0
        self.peak = 0
        self._held = set()

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._held.discard(key)
        self.live -= n

    def _record(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::", 1)[1]
        if name in _LOCAL_FUNCOL:
            return
        if name not in _COLLECTIVE_OPS:
            raise NotImplementedError(f"the dry run does not count {func}")
        group = kwargs.get("group_name", args[-1])
        rows = self.groups.get(group)
        if rows is None:
            raise KeyError(f"{func} over process group {group!r}, which is "
                           f"no mesh dim's")
        if rows.shape[1] == 1:
            return          # a one-rank group moves nothing
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                     if isinstance(t, torch.Tensor))
        self.collectives.append(Collective(_COLLECTIVE_OPS[name], nbytes,
                                           rows))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func in _META_QUERIES:
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        flat = [a for a in tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        if not _program(flat):
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not _program(outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional":
            self._record(func, args, kwargs, out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in flat + outs)
        for t in outs:
            self.hold(t)
        return out


# ------------------------------------------------------------ placement
def _local_shape(shape, pl, mesh) -> tuple:
    sizes = list(mesh_axes(mesh).values())
    out = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            if out[p.dim] % sizes[i]:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split {sizes[i]} ways")
            out[p.dim] //= sizes[i]
    return tuple(out)


def _place(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A meta DTensor of ``t``'s global shape and dtype placed by
    ``spec``, holding only its local shard's (meta) storage."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


class _GatherOnRead:
    """Mixed into a module's class by ``_place_params_``: reading one of
    its ``_gathered`` params returns it all-gathered over the FSDP axes
    (model-axis shards kept), as FSDP gathers a layer's weights before
    use; the gradient flows back to the sharded param (reduce-scatter).
    ``named_parameters`` (the optimizer's view) still yields the shards."""

    def __getattr__(self, name):
        value = super().__getattr__(name)
        pl = self.__dict__.get("_gathered", {}).get(name)
        return value if pl is None else value.redistribute(
            value.device_mesh, pl)


def _place_params_(params: nn.Module, rules: MeshRules,
                   serve: bool) -> nn.Module:
    """Every param of ``params`` replaced, in place, by its meta DTensor
    placed by ``rules.spec_for``; a module holding params sharded on the
    FSDP axes gathers them on each read (``_GatherOnRead``), so DTensor
    moves weights, not activations, as the reference's FSDP axes
    intend."""
    from torch.distributed.tensor import Replicate

    names = list(mesh_axes(rules.mesh))
    fsdp = [i for i, a in enumerate(names) if a in rules.fsdp_axes]
    for mname, mod in params.named_modules():
        gathered = {}
        for pname, p in list(mod._parameters.items()):
            full = f"{mname}.{pname}" if mname else pname
            spec = rules.spec_for(full, tuple(p.shape), serve=serve)
            pl = placements(spec, rules.mesh)
            mod._parameters[pname] = nn.Parameter(
                _place(p, rules.mesh, spec), requires_grad=p.requires_grad)
            if any(pl[i].is_shard() for i in fsdp):
                gathered[pname] = tuple(Replicate() if i in fsdp else q
                                        for i, q in enumerate(pl))
        if gathered:
            cls = type(mod)
            mod.__class__ = type(f"Gathering{cls.__name__}",
                                 (_GatherOnRead, cls), {})
            mod._gathered = gathered
    return params


def _place_state(state, rules: MeshRules, prefix: str = ""):
    """A serve state with every tensor placed by ``serve_state_spec`` (by
    its dotted path); host ints stay."""
    if isinstance(state, dict):
        return {k: _place_state(v, rules, f"{prefix}.{k}" if prefix
                                else str(k)) for k, v in state.items()}
    if isinstance(state, list):
        return [_place_state(v, rules, f"{prefix}.{i}")
                for i, v in enumerate(state)]
    if isinstance(state, torch.Tensor):
        return _place(state, rules.mesh,
                      serve_state_spec(rules, prefix, state.shape))
    return state


def _local_tensors(tree):
    """The plain local shards of a tree's DTensors (params of a module
    included), each storage once."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, nn.Module):
        tree = list(tree.parameters())
    seen, out = set(), []
    for t in tree_leaves(tree, is_leaf=lambda x: isinstance(x, nn.Module)):
        if isinstance(t, nn.Module):
            out += _local_tensors(t)
            continue
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                out.append(t)
    return out


def _nbytes(tensors) -> int:
    return sum(t.untyped_storage().nbytes() for t in tensors)


# ------------------------------------------------------------ steps
def _step_and_args(cfg: ArchConfig, shape: InputShape, rules: MeshRules,
                   opt_cfg: AdamWConfig):
    """(fn, args): the step of the shape's kind and its arguments, meta
    DTensors placed by the rules."""
    mesh = rules.mesh
    model = build_model(cfg)
    batch = {k: _place(v, mesh, rules.batch_spec(tuple(v.shape)))
             for k, v in input_specs(cfg, shape).items()}

    if shape.kind == "train":
        state = abstract_train_state(model, opt_cfg)
        _place_params_(state["params"], rules, serve=False)
        opt = state["opt"]
        for k in ("m", "v"):
            opt[k] = {n: _place(t, mesh, rules.spec_for(n, tuple(t.shape)))
                      for n, t in opt[k].items()}
        opt["step"] = _place(opt["step"], mesh, ())
        return make_train_step(model, opt_cfg), (state, batch)

    if shape.kind == "prefill":
        params = _place_params_(model.init_abstract(), rules, serve=False)
        cache_len = shape.seq_len
        src_len = batch["frames"].shape[1] if "frames" in batch else 0
        empty = model.init_serve_state(shape.global_batch, cache_len,
                                       src_len, device="meta")

        def prefill_fn(params, batch):
            # the state is made inside the step, as the reference's is
            return model.prefill(params, batch, cache_len,
                                 state=_place_state(empty, rules))

        return prefill_fn, (params, batch)

    params = _place_params_(model.init_abstract(), rules, serve=True)
    state = _place_state(serve_state_specs(cfg, shape), rules)
    win = decode_window(cfg, shape)

    def decode_fn(params, tokens, state):
        return model.decode(params, tokens, state, window_override=win)

    return decode_fn, (params, batch["tokens"], state)


@contextlib.contextmanager
def _greedy_redistribution():
    """DTensor plans most redistributions greedily, but one of a
    ``_StridedShard`` (a dim split over two mesh dims and then viewed, as
    the multi-pod batch is) by a Dijkstra search over placements, which on
    the 3-D mesh takes minutes for one attention product. The dry run
    plans those greedily too; the search's cache is cleared after."""
    from torch.distributed.tensor import _redistribute as red

    planner = getattr(red, "DTensorRedistributePlanner", None)
    if planner is None or not hasattr(planner,
                                      "generate_graph_based_transform_infos"):
        yield
        return
    graph = planner.generate_graph_based_transform_infos
    planner.generate_graph_based_transform_infos = \
        lambda self, src, dst, shape: self.generate_greedy_transform_infos(
            src, dst)
    try:
        yield
    finally:
        planner.generate_graph_based_transform_infos = graph
        red._gen_transform_infos.cache_clear()


def _trace(cfg: ArchConfig, shape: InputShape, rules: MeshRules,
           opt_cfg: AdamWConfig, act_constraint: bool = True) -> Dict:
    """Run the step once on meta DTensors under ``_Plan``; its counts."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args = _step_and_args(cfg, shape, rules, opt_cfg)
    plan = _Plan(mesh_groups(rules.mesh))
    arg_locals = _local_tensors(args)
    for t in arg_locals:
        plan.hold(t)
    # decode steps skip the residual-stream constraint: pinning a 1-token
    # activation just forces per-layer reshards
    act_axes = (rules.batch_axes
                if (shape.kind != "decode" and act_constraint) else ())
    t0 = time.perf_counter()
    with plan, implicit_replication(), _greedy_redistribution(), \
            activation_sharding(rules.mesh, act_axes):
        out = fn(*args)
    wall = time.perf_counter() - t0
    arg_bytes = _nbytes(arg_locals)
    return {
        "flops": float(plan.flops),
        "hlo_bytes": float(plan.bytes),
        "collective_bytes": collective_bytes(plan.collectives),
        "trace_s": wall,
        "argument_bytes": arg_bytes,
        "output_bytes": _nbytes(_local_tensors(out)),
        "peak_bytes": plan.peak,
        "temp_bytes": plan.peak - arg_bytes,
    }


def _extrapolate(cfg: ArchConfig, m1: Dict, m2: Dict) -> Dict:
    """The reference's layer extrapolation from the L=1 and L=2 probes:
    body = m2 - m1, base = m1 - body, total(L) = base + L*body (per
    metric, incl. each collective kind). The reference clamps body and
    base at 0 against XLA's loop-body counting; these counts are exact,
    and a collective kind that the first layer uses less than the others
    has a negative base, which a clamp would misreport."""
    L = cfg.num_layers
    out = {}
    for key in ("flops", "hlo_bytes"):
        body = m2[key] - m1[key]
        base = m1[key] - body
        out[key] = base + L * body
    coll = {}
    keys = set(m1["collective_bytes"]) | set(m2["collective_bytes"])
    for k in keys:
        a = m1["collective_bytes"].get(k, 0.0)
        b = m2["collective_bytes"].get(k, 0.0)
        body = b - a
        base = a - body
        coll[k] = base + L * body
    out["collective_bytes"] = coll
    return out


def _extrapolation_gap(extr: Dict, direct: Dict) -> float:
    """The probes' extrapolation against the direct count: the FLOPs must
    be equal (every layer computes alike); returns the largest relative
    gap of the bytes and of each collective kind, which DTensor can move
    by a few scalar reductions (the gradient norm's partial sums settle
    into their per-layer pattern after the first layers)."""
    if extr["flops"] != direct["flops"]:
        raise AssertionError(f"L=1/L=2 extrapolation {extr['flops']} FLOPs "
                             f"!= the direct count {direct['flops']}")
    pairs = [(extr["hlo_bytes"], direct["hlo_bytes"])]
    kinds = set(extr["collective_bytes"]) | set(direct["collective_bytes"])
    pairs += [(extr["collective_bytes"].get(k, 0.0),
               direct["collective_bytes"].get(k, 0.0)) for k in kinds]
    return max((abs(a - b) / max(abs(b), 1.0) for a, b in pairs),
               default=0.0)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               fsdp_over_pod: bool = False,
               extrapolate: bool = True,
               verbose: bool = True,
               reduced: bool = False,
               mesh_override=None,
               shape_override: Optional[InputShape] = None,
               cfg_override: Optional[ArchConfig] = None,
               tp_over_pod: bool = False,
               pure_fsdp: bool = False,
               act_constraint: bool = True,
               device=None) -> Dict:
    """Plan one (arch, shape) on the production mesh (``multi_pod``: the
    2x16x16 one) or on ``mesh_override`` (a DeviceMesh whose process
    group the caller holds). ``device`` is the production mesh's device
    type (None = the CUDA card). Returns the reference's result dict
    (``lower_s`` is the trace's wall; nothing is compiled, so
    ``compile_s`` is 0)."""
    cfg = cfg_override or get_config(arch, reduced=reduced)
    shape = shape_override or SHAPES[shape_name]
    with contextlib.ExitStack() as world:
        mesh = mesh_override
        if mesh is None:
            world.enter_context(fake_world(math.prod(
                production_shape(multi_pod)[0])))
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rules = MeshRules(mesh, fsdp_over_pod=fsdp_over_pod,
                          tp_over_pod=tp_over_pod, pure_fsdp=pure_fsdp)
        return _plan(arch, shape_name, cfg, shape, rules, multi_pod,
                     fsdp_over_pod, extrapolate, verbose, act_constraint)


def _plan(arch, shape_name, cfg: ArchConfig, shape: InputShape,
          rules: MeshRules, multi_pod, fsdp_over_pod, extrapolate, verbose,
          act_constraint) -> Dict:
    """``dryrun_one`` inside its process group."""
    mesh = rules.mesh
    opt_cfg = AdamWConfig()

    m = _trace(cfg, shape, rules, opt_cfg, act_constraint)
    gap = None
    if extrapolate:
        enc = cfg.encoder_layers
        probes = [_trace(dataclasses.replace(
            cfg, num_layers=n, unroll_layers=True,
            encoder_layers=n if enc else 0), shape, rules, opt_cfg,
            act_constraint) for n in (1, 2)]
        gap = _extrapolation_gap(_extrapolate(cfg, *probes), m)

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.mesh.shape),
        "multi_pod": multi_pod,
        "fsdp_over_pod": fsdp_over_pod,
        "devices": int(mesh.size()),
        "lower_s": round(m["trace_s"], 1),
        "compile_s": 0.0,
        "flops_raw": m["flops"],
        "hlo_bytes_raw": m["hlo_bytes"],
        "collective_bytes_raw": m["collective_bytes"],
        "flops": m["flops"],
        "hlo_bytes": m["hlo_bytes"],
        "collective_bytes": m["collective_bytes"],
        "memory": {k: m[k] for k in ("argument_bytes", "output_bytes",
                                     "temp_bytes", "peak_bytes")},
        "extrapolation_gap": gap,
    }
    if verbose:
        coll = m["collective_bytes"]
        print(f"[dryrun] {arch} x {shape_name} mesh={result['mesh']} "
              f"trace={m['trace_s']:.1f}s flops={result['flops']:.3e} "
              f"bytes={result['hlo_bytes']:.3e} "
              f"coll={sum(v for k, v in coll.items() if '_pod' not in k):.3e}")
        print(f"  memory: {result['memory']}")
        print(f"  collectives: {coll}")
        print(f"  roofline: {roofline_report(cfg, shape, result)}")
    return result


def _host_plan(arch: str, shape_name: str, layers: Optional[int],
               batch: Optional[int], device) -> Dict:
    """Plan (arch, shape) on this process's one device (``make_host_mesh``),
    cut to ``layers`` layers and a global batch of ``batch`` where given:
    the plan of a point that one card can run."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = SHAPES[shape_name]
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    with host_world(device):
        mesh = make_host_mesh(device=device)
        return dryrun_one(arch, shape_name, mesh_override=mesh,
                          cfg_override=cfg, shape_override=shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the CUDA card)")
    ap.add_argument("--host", action="store_true",
                    help="plan on this process's one device instead of the "
                         "production mesh")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --host: cut the config to this many layers")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --host: the global batch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    if args.host:
                        results.append(_host_plan(arch, shape, args.layers,
                                                  args.batch, args.device))
                    else:
                        results.append(dryrun_one(
                            arch, shape, multi_pod=mp,
                            fsdp_over_pod=args.fsdp_over_pod,
                            device=args.device))
                except Exception as e:  # noqa: BLE001 (reported, counted)
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n[dryrun] {len(results)} ok, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
