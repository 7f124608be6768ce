"""Small configurations and traffic for the CPU tests: the cells' shapes
of block and traffic at widths a test run holds, in float32."""
from __future__ import annotations

import copy
import time
from typing import Dict

from . import harness

GQA = {"block": "gqa_dense", "num_hidden_layers": 2, "hidden_size": 64,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "intermediate_size": 128, "vocab_size": 512, "rope_theta": 10000.0,
       "layer_norm_eps": 1e-6, "use_qk_norm": True,
       "tie_word_embeddings": True, "source": "test",
       "torch_dtype": "float32", "compute_dtype": "float32"}
#: GQA with an output table of its own and no QK-norm (serving only)
GQA_UNTIED = dict(GQA, use_qk_norm=False, tie_word_embeddings=False)
MLA_MOE = {"block": "mla_moe", "num_hidden_layers": 2, "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16,
           "moe_intermediate_size": 32, "n_routed_experts": 8,
           "num_experts_per_tok": 2, "n_shared_experts": 1,
           "capacity_factor": 1.25, "moe_group_size": 16, "vocab_size": 512,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "source": "test",
           "torch_dtype": "float32", "compute_dtype": "float32"}
CHAT = {"kind": "serve", "max_batch": 4, "prompt_len": 16, "new_tokens": 6,
        "cache_len": 24, "judge_batches": 1}
#: a run judges up to 16 of its batches: 256 first tokens
PREFILL = {"kind": "serve", "max_batch": 16, "prompt_len": 32,
           "new_tokens": 1, "cache_len": 40, "judge_batches": 16}
TRAIN = {"kind": "train", "batch": 4, "seq_len": 16,
         "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "weight_decay": 0.1, "grad_clip": 1.0,
                       "fp32_moments": False},
         "warmup_steps": 1, "total_steps": 100, "remat": "full",
         "checked_steps": 3}
#: each cell of BENCHMARK.json at a test's size: (configuration, traffic);
#: dsv2-chat (its configuration and limits kept under ``configs/`` and
#: ``limits/``, no entry in BENCHMARK.json) keeps the MoE and MLA paths
#: tested
SMALL = {"cmdr-chat": (GQA, CHAT), "dsv2-chat": (MLA_MOE, CHAT),
         "cmdr-prefill": (GQA, PREFILL), "cmdr-train": (GQA, TRAIN)}
#: the entry of a cell that BENCHMARK.json does not list
OFF_LIST = {"dsv2-chat": {"name": "dsv2-chat", "config": "deepseek-v2",
                          "traffic": "chat", "chips": 1}}


def spec() -> Dict:
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def files(cell: str, **extra) -> Dict:
    """The cell's entry and its committed limits, with the small
    configuration and traffic."""
    cfg, tr = SMALL[cell]
    if cell in OFF_LIST:
        entry = OFF_LIST[cell]
        limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    else:
        real = harness.cell_files(spec(), cell)
        entry, limits = real["cell"], real["limits"]
    out = {"cell": entry, "config": copy.deepcopy(cfg),
           "traffic": copy.deepcopy(tr), "limits": limits}
    out.update(extra)
    return out


def run(cell: str, seed: int = 2147483647 + 11, seconds: float = 0.3,
        trace: bool = False, **extra) -> Dict:
    """One run of the cell at its small size on the CPU, past the look for
    a card."""
    return harness.run_cell(cell, files(cell, **extra), spec(), seed,
                            seconds, trace, "cpu", time.perf_counter())
