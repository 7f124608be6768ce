"""The plain reference against the port at small widths on the CPU, in
float32; the control and the planted faults come out not correct.

At these sizes both sides run float32, where the port and the reference
agree to rounding; the limits here are for that size (the committed
limits are set from readings at the cells' sizes on the card)."""
import numpy as np
import pytest
import torch

from perfbench import judge, layout, port, reference, testing, weights

SEED = 2**31 + 99
#: float32 limits at the test's size: the port reads 0 or rounding
SMALL_LIMITS = {
    "cmdr-chat": {"token_gap": {"limit": 1e-3}},
    "dsv2-chat": {"mean_gap": {"limit": 1e-4}},
    "cmdr-prefill": {"token_gap": {"limit": 1e-3}},
    "cmdr-train": {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-5},
                   "grad_diff": {"limit": 1e-5}, "change_gap": {"limit": 1e-4}},
}


def run(cell, **extra):
    return testing.run(cell, seed=SEED, limits=SMALL_LIMITS[cell], **extra)


@pytest.mark.parametrize("cfg", [testing.GQA, testing.MLA_MOE,
                                 testing.GQA_UNTIED],
                         ids=["gqa", "mla_moe", "gqa_untied"])
def test_prefill_logits_match_the_port(cfg):
    m = layout.dims(cfg)
    arch = port.arch_config(m, cfg, "small")
    params = port.params_from(arch, weights.draw_all(SEED, m, "cpu",
                                                     torch.float32))
    from repro_torch.models import build_model
    tokens = torch.randint(0, m.vocab, (4, 16), generator=torch.Generator()
                           .manual_seed(3))
    got, _ = build_model(arch).prefill(params, {"tokens": tokens}, 24)
    w = judge.Weights(SEED, m, "cpu", torch.float32)
    h = reference.final_hidden(m, w.layer, w.embed["embed.table"],
                               w.head["final_norm.scale"], tokens,
                               judge.moe_groups(m, 4, 16, 1, "cpu"))
    want = h[:, -1] @ w.table.T
    assert torch.allclose(got[:, 0], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cell", sorted(testing.SMALL))
def test_port_agrees_with_the_reference(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_the_reference_keeps_params_in_the_jobs_dtype(monkeypatch):
    """With bf16 params a norm scale near 1 takes no update under half an
    ulp: the reference, keeping its params and moments in the job's
    dtypes, agrees with the port; kept in float32 it moves the scales the
    port cannot, and the worst leaf's change gap is a norm scale's."""
    from perfbench import harness, reference_train
    lim = {"change_gap": {"limit": 0.02}}
    files = testing.files("cmdr-train", limits=lim)
    files["config"] = dict(testing.GQA, torch_dtype="bfloat16",
                           compute_dtype="bfloat16")
    kept = harness.run_cell("cmdr-train", files, testing.spec(), SEED, 0.3,
                            False, "cpu", 0.0)
    assert kept["correct"], kept["checks"]
    init = reference_train.RefTrainer.__init__

    def float32_kept(self, *a, **k):
        init(self, *a, **k)
        self.dtype = self.moment_dtype = torch.float32
    monkeypatch.setattr(reference_train.RefTrainer, "__init__", float32_kept)
    loose = harness.run_cell("cmdr-train", files, testing.spec(), SEED, 0.3,
                             False, "cpu", 0.0)
    assert not loose["correct"]
    assert loose["readings"]["change_leaf"].endswith("norm.scale")


@pytest.mark.parametrize("cell", ["cmdr-chat", "dsv2-chat", "cmdr-prefill"])
def test_serving_control_is_not_correct(cell):
    """The control, the reference in float8 in the program's place, reads
    far above what the port reads and the harness's own checks find it
    not correct."""
    r = run(cell, control=True)
    key = next(iter(SMALL_LIMITS[cell]))
    assert r["correct"], r["checks"]
    ctl = r["sides"]["control"]
    assert not ctl["correct"]
    assert not ctl["checks"][key]["ok"]
    assert ctl["readings"][key] > SMALL_LIMITS[cell][key]["limit"] \
        >= r["readings"][key]


def test_training_control_and_half_batch_are_not_correct():
    r = run("cmdr-train", control=True)
    assert r["correct"], r["checks"]
    for what in ("control", "half_batch"):
        assert not r["sides"][what]["correct"], what
    assert r["readings"]["grad_diff"] < 1e-5 < \
        r["sides"]["control"]["readings"]["grad_diff"]


# ------------------------------------------------------------------ faults
def _alter_a_token(monkeypatch):
    from repro_torch.serve import ServeEngine
    orig = ServeEngine._sample
    calls = {"n": 0}

    def sample(self, logits, temperature):
        tok = orig(self, logits, temperature)
        calls["n"] += 1
        if calls["n"] % 3 == 2:       # the window's first token among them
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(ServeEngine, "_sample", sample)


def _decode_keeps_its_state(monkeypatch):
    from repro_torch.models import api
    orig = api.Model.decode

    def decode(self, params, tokens, state, window_override=None):
        saved = [{k: v.clone() for k, v in c["attn"].items()
                  if isinstance(v, torch.Tensor)} for c in state["cache"]]
        pos = [c["attn"]["pos"] for c in state["cache"]]
        logits, new = orig(self, params, tokens, state, window_override)
        for c, s, p in zip(new["cache"], saved, pos):
            for k, v in s.items():
                c["attn"][k].copy_(v)
            c["attn"]["pos"] = p
        return logits, dict(new, pos=state["pos"])
    monkeypatch.setattr(api.Model, "decode", decode)


def _update_does_nothing(monkeypatch):
    from repro_torch.train import train_step

    def adamw_update(params, grads, state, cfg, lr_scale=1.0):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(train_step, "adamw_update", adamw_update)


def _half_the_batch(monkeypatch):
    from repro_torch.models import api
    orig = api.Model.train_loss

    def train_loss(self, params, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(self, params, half)
    monkeypatch.setattr(api.Model, "train_loss", train_loss)


FAULTS = [("cmdr-chat", _alter_a_token), ("dsv2-chat", _alter_a_token),
          ("cmdr-prefill", _alter_a_token),
          ("cmdr-chat", _decode_keeps_its_state),
          ("dsv2-chat", _decode_keeps_its_state),
          ("cmdr-train", _update_does_nothing),
          ("cmdr-train", _half_the_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not run(cell)["correct"]


def test_moe_groups_cover_every_token_once():
    m = layout.dims(testing.MLA_MOE)
    g = judge.moe_groups(m, 4, 16, 6, "cpu")
    flat = torch.cat([x.reshape(-1) for x in g])
    assert sorted(flat.tolist()) == list(range(4 * 21))
    assert [tuple(x.shape) for x in g] == [(4, 16), (5, 4)]
    assert reference.capacity(m, 16) == int(np.ceil(16 * 2 / 8 * 1.25))


def test_weights_are_drawn_again_bit_for_bit(monkeypatch):
    """A group drawn again, whole or a chunk at a time, is the group the
    program was given; other seeds and groups differ."""
    monkeypatch.setattr(weights, "DRAW_CHUNK", 1000)
    m = layout.dims(testing.MLA_MOE)
    g, leaves = layout.groups(m)[1]
    first = weights.draw_group(SEED, g, leaves, "cpu")
    again = weights.draw_group(SEED, g, leaves, "cpu")
    assert all(torch.equal(first[n], again[n]) for n in first)
    assert first["layers.0.moe.router"].dtype == torch.float32
    for n, at, piece in weights.group_pieces(SEED, g, leaves, "cpu"):
        assert torch.equal(first[n].reshape(-1)[at:at + piece.numel()], piece)
    other = weights.draw_group(SEED + 1, g, leaves, "cpu")
    assert not torch.equal(first["layers.0.attn.wo"], other["layers.0.attn.wo"])
