"""Blocks as files of their own (``perfbench/blocks/``).

What the harness draws, counts and computes for each configuration is
pinned to the values the harness gave before its blocks moved into their
own files, bit for bit: the leaves (digests of name, shape, kind, std and
float32, group by group, whose names seed the draws), the parameter
counts, the norm plan at the cells' row counts, the model FLOPs of the
cells' shapes (as ``float.hex``), the MoE's dispatch groups at
dsv2-chat's shapes, the reference's hidden states and training steps at
the small sizes, and the judged rows. A copy of a block file under a new
name runs whole cells on the CPU as the original does, and no harness
file outside ``blocks/`` names or compares a block.
"""
import ast
import hashlib
import itertools
import re
import shutil
from types import SimpleNamespace

import pytest
import torch

from perfbench import (blocks, counts, harness, judge, layout, reference,
                       reference_train, serve_cell, testing, train_cell)
from perfbench.test_perfbench_imports import _top_level_imports

SEED = 2**31 + 99
CONFIGS = {n: harness.load_json(harness.HERE / "configs" / f"{n}.json")
           for n in ("command-r-plus", "command-r-plus-1layer",
                     "deepseek-v2")}
CONFIGS.update(GQA=testing.GQA, GQA_UNTIED=testing.GQA_UNTIED,
               MLA_MOE=testing.MLA_MOE)
SMALL = ("GQA", "GQA_UNTIED", "MLA_MOE")
#: norm_plan's row counts: cmdr-chat's prefill and decode, cmdr-prefill's
#: prefill and its batch, cmdr-train's step, the small cells' prefill
NORM_ROWS = (65536, 128, 8192, 4, 1024, 64)

#: (leaves, leaf count, param_count, matrix_params, norm_plan)
LAYOUT = {
    "command-r-plus": ("ee6f71734a6266203dfc642a", 134, 22020406272,
                       22020096000, "befaa463cd79b48412ff9511"),
    "command-r-plus-1layer": ("0ae43dd06bba87f4b6ad5624", 13, 4718629120,
                              4718592000, "1464012ac18a63111d77ef7a"),
    "deepseek-v2": ("f4723bbf3b932f2517b085f7", 105, 24881280000,
                    24881201152, "79a7da56b18981b59d4f9da7"),
    "GQA": ("61b1790a197320a36405c54c", 24, 106880, 106496,
            "24b6d2c0cf40e3fa5601d680"),
    "GQA_UNTIED": ("28ceeb6598cf701e25f1553e", 21, 139584, 139264,
                   "a05ab0409f615b7151f73d97"),
    "MLA_MOE": ("28b9cd2c880aab1f6bd09959", 37, 203168, 202752,
                "dca84e9a5b65c2aaaf754df1"),
}
#: serve_batch_flops(m, 128, 512, 128), prefill_flops(m, 4, 2048) and
#: cmdr-train's train_step_flops (16 x 64 tokens)
FLOPS = {
    "command-r-plus": ("0x1.6c7cac0000000p+51", "0x1.1dc66c0000000p+48",
                       "0x1.ec9c000000000p+46"),
    "command-r-plus-1layer": ("0x1.48edc80000000p+48",
                              "0x1.7d5e800000000p+44",
                              "0x1.a604000000000p+44"),
    "deepseek-v2": ("0x1.49c0a70000000p+48", "0x1.105d900000000p+45",
                    "0x1.1647b00000000p+47"),
    "GQA": ("0x1.8b68000000000p+34", "0x1.4824000000000p+32",
            "0x1.6800000000000p+29"),
    "GQA_UNTIED": ("0x1.8b68000000000p+34", "0x1.4824000000000p+32",
                   "0x1.c800000000000p+29"),
    "MLA_MOE": ("0x1.a45e000000000p+34", "0x1.7e2c000000000p+32",
                "0x1.4d00000000000p+30"),
}
NO_GROUPS = "e3b0c44298fc1c149afbf4c8"
#: judge.moe_groups at dsv2-chat's shapes (128, 512, 128) and at the small
#: chat's (4, 16, 6)
GROUPS = {
    "command-r-plus": (NO_GROUPS, NO_GROUPS),
    "command-r-plus-1layer": (NO_GROUPS, NO_GROUPS),
    "deepseek-v2": ("e643e19e8303940900e3c85e", "bef127a644095ca51fd43b45"),
    "GQA": (NO_GROUPS, NO_GROUPS),
    "GQA_UNTIED": (NO_GROUPS, NO_GROUPS),
    "MLA_MOE": ("97621406514ae2a4b9bf3767", "1ee11cc74093c8a25dcde2ca"),
}
#: reference.final_hidden over (4, 21) tokens, the small chat's groups,
#: in float32 and under the float8 control
HIDDEN = {
    "GQA": ("5f316c4a2d03f0aababaf663", "ed1aa78e9fdb3c6e67e69414"),
    "GQA_UNTIED": ("8be39cdd39f2e2c62d67dbb0", "209108fee1b1b69f1d5ed6a0"),
    "MLA_MOE": ("e64e341dccee6aad8aeea8b8", "43c9acca12ac60765f67e8bc"),
}
#: three training reference steps of GQA: losses, first gradient norms and
#: change norms
TRAIN_REFERENCE = "212131e418d7dc6486a56f02"
#: serve_cell.judged_rows of cmdr-chat's first three batches
JUDGED_ROWS = [
    [20, 21, 31, 50, 52, 57, 59, 69, 75, 76, 82, 86, 88, 93, 95, 124],
    [2, 9, 24, 25, 26, 34, 36, 38, 47, 57, 59, 74, 99, 107, 117, 119],
    [9, 10, 18, 30, 41, 42, 57, 60, 62, 67, 71, 105, 113, 115, 116, 125]]


def digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:24]


def tensors_digest(ts) -> str:
    d = hashlib.sha256()
    for t in ts:
        d.update(repr((tuple(t.shape), str(t.dtype))).encode())
        d.update(t.detach().contiguous().cpu().numpy().tobytes())
    return d.hexdigest()[:24]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_leaves_counts_and_norm_plan_are_pinned(name):
    m = layout.dims(CONFIGS[name])
    leaves = [(g, [(x.name, x.shape, x.kind, x.std, x.float32) for x in ls])
              for g, ls in layout.groups(m)]
    got = (digest(leaves), sum(len(ls) for _, ls in leaves),
           layout.param_count(m), counts.matrix_params(m),
           digest([layout.norm_plan(m, r) for r in NORM_ROWS]))
    assert got == LAYOUT[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_flops_are_pinned(name):
    m = layout.dims(CONFIGS[name])
    got = (counts.serve_batch_flops(m, 128, 512, 128).hex(),
           counts.prefill_flops(m, 4, 2048).hex(),
           float(counts.train_step_flops(m, counts.matrix_params(m),
                                         16 * 64, 64)).hex())
    assert got == FLOPS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dispatch_groups_are_pinned(name):
    m = layout.dims(CONFIGS[name])
    got = (tensors_digest(judge.moe_groups(m, 128, 512, 128, "cpu")),
           tensors_digest(judge.moe_groups(m, 4, 16, 6, "cpu")))
    assert got == GROUPS[name]


@pytest.mark.parametrize("name", SMALL)
def test_reference_hidden_states_are_pinned(name):
    m = layout.dims(CONFIGS[name])
    w = judge.Weights(SEED, m, "cpu", torch.float32)
    tokens = torch.randint(0, m.vocab, (4, 21),
                           generator=torch.Generator().manual_seed(3))
    grp = judge.moe_groups(m, 4, 16, 6, "cpu")
    got = tuple(tensors_digest([reference.final_hidden(
        m, w.layer, w.embed["embed.table"], w.head["final_norm.scale"],
        tokens, grp, prec)]) for prec in (reference.FP32, reference.FP8))
    assert got == HIDDEN[name]


def test_training_reference_is_pinned():
    m = layout.dims(testing.GQA)
    batches = [torch.randint(0, m.vocab, (4, 16),
                             generator=torch.Generator().manual_seed(k))
               for k in range(3)]
    r = reference_train.run_reference(m, SEED, "cpu",
                                      testing.TRAIN["optimizer"], 1, 100,
                                      batches, dtype=torch.float32)
    assert digest([[x.hex() for x in r["losses"]],
                   sorted((k, v.hex()) for k, v in r["first_grads"].items()),
                   sorted((k, v.hex()) for k, v in r["changes"].items())]) \
        == TRAIN_REFERENCE


def test_judged_rows_are_pinned():
    m = layout.dims(CONFIGS["command-r-plus"])
    tr = harness.load_json(harness.HERE / "traffic" / "chat.json")
    assert [serve_cell.judged_rows(m, tr, SEED, k).tolist()
            for k in range(3)] == JUDGED_ROWS


# ------------------------------------------------------------ block files
#: float32 limits at the small size (as test_perfbench_reference's)
SMALL_LIMITS = {
    "cmdr-chat": {"token_gap": {"limit": 1e-3}},
    "cmdr-train": {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-5},
                   "grad_diff": {"limit": 1e-5},
                   "change_gap": {"limit": 1e-4}},
}


@pytest.mark.parametrize("cell", sorted(SMALL_LIMITS))
def test_a_block_is_taken_from_its_file_alone(cell, tmp_path, monkeypatch):
    """gqa_dense.py copied under a new name into another directory, the
    loader pointed there, runs the whole small cell as the original does:
    the same result, bit for bit. The cells' clock is a counter, so both
    runs' windows hold the same batches or steps."""
    def run(block):
        clock = itertools.count()
        fake = SimpleNamespace(perf_counter=lambda: float(next(clock)))
        monkeypatch.setattr(serve_cell, "time", fake)
        monkeypatch.setattr(train_cell, "time", fake)
        files = testing.files(cell, limits=SMALL_LIMITS[cell])
        files["config"]["block"] = block
        return harness.run_cell(cell, files, testing.spec(), SEED, 2.5,
                                False, "cpu", 0.0)

    want = run("gqa_dense")
    shutil.copy(blocks.DIR / "gqa_dense.py", tmp_path / "gqa_copy.py")
    monkeypatch.setattr(blocks, "DIR", tmp_path)
    got = run("gqa_copy")
    copy = blocks.load("gqa_copy")
    assert copy.__file__ == str(tmp_path / "gqa_copy.py")
    m = layout.dims(dict(testing.GQA, block="gqa_copy"))
    assert type(m) is copy.GQADims
    assert want["correct"] and want["attempted"] > 0, want["checks"]
    assert got == want


def test_an_unknown_block_is_refused_with_the_block_files(monkeypatch,
                                                          tmp_path):
    with pytest.raises(ValueError, match="gqa_dense.*mla_moe"):
        layout.dims(dict(testing.GQA, block="no_such_block"))
    for name in ("../layout", "__init__", "gqa_dense.py", ""):
        with pytest.raises(ValueError, match="unknown block"):
            blocks.load(name)
    assert blocks.load("gqa_dense") is blocks.load("gqa_dense")
    monkeypatch.setattr(blocks, "DIR", tmp_path)
    with pytest.raises(ValueError, match=r"\[\]"):
        blocks.load("gqa_dense")


def _harness_files():
    for path in sorted(harness.HERE.rglob("*.py")):
        rel = path.relative_to(harness.HERE)
        if rel.parts[0] == "blocks" or path.name.startswith("test_") \
                or path.name == "testing.py":
            continue
        yield rel, path.read_text()


def _reads_block(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "block"


def test_no_harness_file_outside_blocks_names_or_compares_a_block():
    """A block's name appears only in its own file (and in configuration
    files and tests); no harness file branches on ``.block``: no
    comparison, match or table lookup of it."""
    names = [p.stem for p in blocks.DIR.glob("*.py")
             if not p.stem.startswith("_")]
    assert {"gqa_dense", "mla_moe"} <= set(names)
    seen = 0
    for rel, text in _harness_files():
        seen += 1
        for name in names:
            assert not re.search(rf"\b{re.escape(name)}\b", text), (rel, name)
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
            elif isinstance(node, ast.Match):
                sides = [node.subject]
            elif isinstance(node, ast.Subscript):
                sides = [node.slice]
            else:
                continue
            assert not any(map(_reads_block, sides)), (rel, node.lineno)
    assert seen >= 20


def test_the_block_files_import_nothing_of_the_port():
    """The reference's layers live in the block files: like the rest of
    the reference they import no module of the port (``arch_config`` goes
    through ``port``)."""
    for path in blocks.DIR.glob("*.py"):
        assert not _top_level_imports(path) & {
            "repro_torch", "repro", "jax", "jaxlib", "flax"}, path
