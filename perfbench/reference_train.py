"""The plain reference of a training cell: three AdamW steps of the
decoder in float32, from the benchmark's weights, each layer its block's
``layer`` (a block whose ``TRAINABLE`` is set; ``blocks/<block>.py``).

It follows the job as its traffic file states it: the next-token
cross-entropy over every position but the last, the gradient clipped to
a global norm, AdamW with weight decay on every parameter, the learning
rate scaled by the linear warm-up and cosine decay of the step counter
before its increment. Each step is computed in float32; the params and
moments it keeps are rounded to the dtypes the job keeps them in (the
configuration's params; bf16 moments unless the traffic asks for float32
ones), as the program keeps them. So an update under half an ulp of the
kept dtype leaves a value where it was on both sides, as bf16 does to a
norm scale near 1 at lr 1e-3.

The head reads the embedding's table (a configuration whose head has a
table of its own is refused). To fit one card beside nothing else, the
table's gradient is never held whole: it is made block by block over the
vocabulary, the embedding's gradient rows added to each block, once to
sum its squares for the clip and once more to update.

``Precision`` FP8 is the control here too: each weight product's
operands rounded to float8 in the forward, the gradient passed straight
through the rounding.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from . import blocks
from . import reference as ref
from .layout import Dims, groups, layer_leaves
from .weights import draw_group

VOCAB_BLOCK = 16384
#: the table the embedding and the head share
TABLE = "embed.table"
SLAB = 1 << 26


def square_sum(a: torch.Tensor, b: torch.Tensor = None) -> float:
    """The sum of the squares of a (or of a - b), in float32 slabs summed
    in float64: no copy of a whole tensor."""
    xs = a.reshape(-1).split(SLAB)
    ys = b.reshape(-1).split(SLAB) if b is not None else [None] * len(xs)
    total = 0.0
    for x, y in zip(xs, ys):
        d = x.float() if y is None else x.float() - y.float()
        total += float(torch.sum(d * d, dtype=torch.float64))
    return total


def lr_scale(step: int, warmup: int, total: int, final_frac: float = 0.1
             ) -> float:
    """Linear warm-up over ``warmup`` steps, then cosine decay to
    ``final_frac`` at ``total``; ``step`` counts the updates made before."""
    warm = min(max(step / max(warmup, 1), 0.0), 1.0)
    t = min(max(max(step - warmup, 0) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (final_frac + (1 - final_frac) * 0.5
                   * (1 + math.cos(math.pi * t)))


class Fp8Straight(ref.Precision):
    """float8 operands in the forward, the gradient straight through."""

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(torch.float32), w.to(torch.float32)
        xq = x + (ref.to_fp8(x.detach(), -1) - x.detach())
        wq = w + (ref.to_fp8(w.detach(), 0) - w.detach())
        return xq @ wq


FP8_TRAIN = Fp8Straight("fp8")


class FirstGrads:
    """A side's first clipped gradient, held on the host (bfloat16) while
    the reference runs: a tensor a leaf, the table among them, and
    ``scale`` to multiply by (the program hands AdamW's first moment,
    m = (1 - b1) g)."""

    def __init__(self, dense: Dict[str, torch.Tensor], scale: float):
        self.dense, self.scale = dense, scale

    @classmethod
    def of_program(cls, moments: Dict[str, torch.Tensor], b1: float
                   ) -> "FirstGrads":
        """From the program's first moments after one step."""
        return cls({n: t.detach().to("cpu", copy=True)
                    for n, t in moments.items()}, 1.0 / (1 - b1))

    @classmethod
    def of_reference(cls, grads, table_grad: Callable, blocks, clip,
                     m: Dims) -> "FirstGrads":
        dense = {n: (g * clip).to(torch.bfloat16).cpu()
                 for n, g in grads.items()}
        u = torch.empty(m.vocab, m.d, dtype=torch.bfloat16)
        for lo in blocks:
            u[lo:lo + VOCAB_BLOCK] = (table_grad(lo) * clip) \
                .to(torch.bfloat16).cpu()
        dense[TABLE] = u
        return cls(dense, 1.0)

    def diffs(self, grads, table_grad: Callable, blocks, clip
              ) -> Dict[str, float]:
        """Each leaf's squared norm of (this side's gradient - the
        reference's), the host tensors brought over a slab at a time."""
        out = {n: self._sq(self.dense[n], g * clip) for n, g in grads.items()}
        u = self.dense[TABLE]
        out[TABLE] = sum(self._sq(u[lo:lo + VOCAB_BLOCK],
                                  table_grad(lo) * clip) for lo in blocks)
        return out

    def _sq(self, host: torch.Tensor, want: torch.Tensor) -> float:
        total = 0.0
        for h, w_ in zip(host.reshape(-1).split(SLAB),
                         want.reshape(-1).split(SLAB)):
            d = h.to(w_.device).float() * self.scale - w_.float()
            total += float(torch.sum(d * d, dtype=torch.float64))
        return total


class RefTrainer:
    def __init__(self, m: Dims, seed: int, device, opt: Dict, warmup: int,
                 total: int, prec: ref.Precision = ref.FP32,
                 dtype=torch.bfloat16,
                 firsts: Optional[Dict[str, "FirstGrads"]] = None,
                 keep_first: bool = False):
        if not blocks.load(m.block).TRAINABLE or not m.tied:
            raise NotImplementedError(
                "the training reference takes a block whose TRAINABLE is "
                "set, its head reading the embedding's table (block "
                f"{m.block!r}, tied {m.tied})")
        self.m, self.seed, self.device, self.dtype = m, seed, device, dtype
        self.moment_dtype = torch.float32 if opt["fp32_moments"] else dtype
        self.opt, self.warmup, self.total, self.prec = opt, warmup, total, prec
        self.params: Dict[str, torch.Tensor] = {}
        for i in range(m.layers):
            for name, t in draw_group(seed, f"layer.{i}", layer_leaves(m, i),
                                      device, dtype).items():
                self.params[name] = t.to(torch.float32).requires_grad_(True)
        gs = dict(groups(m))
        head = draw_group(seed, "head", gs["head"], device, dtype)
        self.params["final_norm.scale"] = head["final_norm.scale"] \
            .to(torch.float32).requires_grad_(True)
        # U: the table in float32 with its moments
        self.U = draw_group(seed, "embed", gs["embed"], device,
                            dtype)[TABLE].to(torch.float32)
        self.mom = {n: (torch.zeros_like(p), torch.zeros_like(p))
                    for n, p in self.params.items()}
        self.mU, self.vU = torch.zeros_like(self.U), torch.zeros_like(self.U)
        self.step_count = 0
        self.first_grads: Dict[str, float] = {}
        self.firsts = firsts or {}
        self.first_diffs: Dict[str, Dict[str, float]] = {}
        self.keep_first = keep_first
        self.first_host: Optional[FirstGrads] = None

    # ------------------------------------------------------------ step
    def step(self, tokens: torch.Tensor) -> float:
        m, prec = self.m, self.prec
        held, idx = torch.unique(tokens, return_inverse=True)
        E = self.U[held].requires_grad_(True)       # the rows the batch reads
        x = E[idx]
        w = self.params
        for i in range(m.layers):
            x = ref.block(m, w, i, x, [], prec)
        h = ref.rmsnorm(x, w["final_norm.scale"], m.eps)
        h2 = h[:, :-1].reshape(-1, m.d)
        tgt = tokens[:, 1:].reshape(-1)
        n = tgt.numel()
        hd = h2.detach()
        blocks = range(0, m.vocab, VOCAB_BLOCK)
        logits = torch.cat([prec.mm(hd, self.U[lo:lo + VOCAB_BLOCK].T)
                            for lo in blocks], dim=1)
        lse = torch.logsumexp(logits, dim=-1)
        rows = torch.arange(n, device=logits.device)
        loss = float((lse - logits[rows, tgt]).mean())
        d = logits.sub_(lse[:, None]).exp_()
        d[rows, tgt] -= 1.0
        d /= n
        del logits
        dh2 = sum(prec.mm(d[:, lo:lo + VOCAB_BLOCK],
                          self.U[lo:lo + VOCAB_BLOCK]) for lo in blocks)
        dh = torch.zeros_like(h)
        dh[:, :-1] = dh2.view(h.shape[0], h.shape[1] - 1, m.d)
        h.backward(dh)
        del dh, dh2

        def d_u(lo: int) -> torch.Tensor:
            """The table's gradient on a block of rows from lo: the
            head's, and the embedding's rows added."""
            blk = d[:, lo:lo + VOCAB_BLOCK]
            if prec.name == "fp8":
                g = ref.to_fp8(blk.T, -1) @ ref.to_fp8(hd, 0)
            else:
                g = blk.T @ hd
            inside = (held >= lo) & (held < lo + g.shape[0])
            return g.index_add_(0, held[inside] - lo, E.grad[inside])

        sq = {name: square_sum(p.grad) for name, p in w.items()}
        sq[TABLE] = sum(square_sum(d_u(lo)) for lo in blocks)
        gnorm = math.sqrt(sum(sq.values()))
        clip = min(1.0, self.opt["grad_clip"] / (gnorm + 1e-9))
        if self.step_count == 0:
            self.first_grads = {k: math.sqrt(v) * clip for k, v in sq.items()}
            grads = {n: p.grad for n, p in w.items()}
            self.first_diffs = {k: f.diffs(grads, d_u, blocks, clip)
                                for k, f in self.firsts.items()}
            if self.keep_first:
                self.first_host = FirstGrads.of_reference(
                    grads, d_u, blocks, clip, m)

        lr = self.opt["lr"] * lr_scale(self.step_count, self.warmup,
                                       self.total)
        self.step_count += 1
        t = self.step_count
        with torch.no_grad():
            for name, p in w.items():
                self._adamw(p, p.grad, *self.mom[name], clip, lr, t)
                p.grad = None
            # d_u reads d, hd and E.grad, never U: a block updated in place
            # leaves the next block's gradient as it was
            for lo in blocks:
                hi = lo + VOCAB_BLOCK
                self._adamw(self.U[lo:hi], d_u(lo), self.mU[lo:hi],
                            self.vU[lo:hi], clip, lr, t)
        return loss

    def _adamw(self, p, g, mo, v, clip, lr, t) -> None:
        """One AdamW update of p in place, slab by slab."""
        o = self.opt
        bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        for p_, g_, m_, v_ in zip(*(x.reshape(-1).split(SLAB)
                                    for x in (p, g, mo, v))):
            g_ = g_ * clip
            m_.mul_(o["b1"]).add_((1 - o["b1"]) * g_)
            v_.mul_(o["b2"]).add_((1 - o["b2"]) * g_ * g_)
            delta = (m_ / bc1) / ((v_ / bc2).sqrt() + o["eps"]) \
                + o["weight_decay"] * p_
            p_.sub_(lr * delta)
            # what is kept is rounded to the dtype the job keeps it in
            for x, dt in ((m_, self.moment_dtype), (v_, self.moment_dtype),
                          (p_, self.dtype)):
                x.copy_(x.to(dt))

    # ------------------------------------------------------------ change
    def change_norms(self) -> Dict[str, float]:
        """Each leaf's norm of (now - its first value), the first values
        drawn again from the seed."""
        m, out = self.m, {}
        for i in range(m.layers):
            for name, p0 in draw_group(self.seed, f"layer.{i}",
                                       layer_leaves(m, i), self.device,
                                       self.dtype).items():
                out[name] = math.sqrt(square_sum(
                    self.params[name].detach(), p0))
        gs = dict(groups(m))
        head = draw_group(self.seed, "head", gs["head"], self.device,
                          self.dtype)
        out["final_norm.scale"] = math.sqrt(square_sum(
            self.params["final_norm.scale"].detach(),
            head["final_norm.scale"]))
        table = draw_group(self.seed, "embed", gs["embed"], self.device,
                           self.dtype)[TABLE]
        out[TABLE] = math.sqrt(square_sum(self.U, table))
        return out


def run_reference(m: Dims, seed: int, device, opt: Dict, warmup: int,
                  total: int, batches: List[torch.Tensor],
                  prec: ref.Precision = ref.FP32,
                  dtype=torch.bfloat16,
                  firsts: Optional[Dict[str, FirstGrads]] = None,
                  keep_first: bool = False) -> Dict:
    """The reference's losses, first-step clipped gradient norms and
    change norms after ``len(batches)`` steps; with ``firsts``, each
    side's squared gradient difference by leaf (``first_diffs``); with
    ``keep_first``, its own first gradients on the host (``first``)."""
    r = RefTrainer(m, seed, device, opt, warmup, total, prec, dtype, firsts,
                   keep_first)
    losses = [r.step(b) for b in batches]
    out = {"losses": losses, "first_grads": r.first_grads,
           "changes": r.change_norms(), "first_diffs": r.first_diffs,
           "first": r.first_host}
    del r
    return out
