"""The yardstick's counts against hand counts at the cells' shapes, and
its shapes against the port's."""
import pytest
import torch

from perfbench import counts, harness, layout

CFG = harness.HERE / "configs"


def dims(name):
    return layout.dims(harness.load_json(CFG / f"{name}.json"))


def test_command_r_plus_shapes_by_hand():
    m = dims("command-r-plus")
    assert (m.layers, m.d, m.heads, m.kv_heads, m.head_dim, m.d_ff,
            m.vocab) == (12, 12288, 96, 8, 128, 33792, 256000)
    per_layer = (12288 * 96 * 128 * 2 + 12288 * 8 * 128 * 2
                 + 3 * 12288 * 33792)
    assert counts.layer_matrix_params(m) == per_layer == 1_572_864_000
    # 12 layers with QK-norm's two 128-wide scales, one table shared by
    # the embedding and the head, 25 norm scales: 22.020 B
    assert m.qk_norm and m.tied
    assert layout.param_count(m) == 12 * (per_layer + 2 * 12288 + 2 * 128) \
        + 256000 * 12288 + 12288 == 22_020_406_272
    assert counts.matrix_params(m) == 12 * per_layer + 256000 * 12288


def test_deepseek_v2_active_params_by_hand():
    m = dims("deepseek-v2")
    attn = (5120 * 1536 + 1536 * 128 * 192 + 5120 * 576
            + 512 * 128 * 256 + 128 * 128 * 5120)
    router = 5120 * 160
    active = router + (6 + 2) * 3 * 5120 * 1536
    assert counts.layer_matrix_params(m) == attn + active
    every = router + (160 + 2) * 3 * 5120 * 1536
    assert counts.layer_matrix_params(m, active=False) == attn + every


def test_serve_flops_by_hand():
    m = dims("command-r-plus")
    B, S, new = 16, 512, 128
    P = counts.layer_matrix_params(m)
    attn = 2 * 12 * 96 * 256
    head = 2 * 12288 * 256000
    want = (2 * 12 * P * B * S + attn * B * S * (S + 1) / 2 + head * B)
    want += sum(2 * 12 * P * B + attn * B * (S + j + 1) + head * B
                for j in range(new - 1))
    assert counts.serve_batch_flops(m, B, S, new) == pytest.approx(want,
                                                                   rel=1e-12)
    assert counts.prefill_flops(m, 4, 2048) == pytest.approx(
        2 * 12 * P * 4 * 2048 + attn * 4 * 2048 * 2049 / 2 + head * 4,
        rel=1e-12)


def test_kernel_counts_by_hand():
    assert counts.flash_causal_flops(4, 2048, 96, 128) \
        == 4 * 4 * 96 * 128 * 2048 * 2049 / 2
    assert counts.rmsnorm_bytes(8192, 12288) == 2 * 8192 * 12288 * 2 \
        + 4 * 12288
    assert counts.rmsnorm_bwd_bytes(1024, 12288) == 3 * 1024 * 12288 * 2
    assert counts.BF16_FLOPS == 989e12 and counts.HBM_BYTES == 3.35e12


@pytest.mark.parametrize("name", ["command-r-plus", "command-r-plus-1layer",
                                  "deepseek-v2"])
def test_layout_is_the_ports(name):
    """Every leaf the benchmark draws is one of the port's parameters, of
    its shape, and the frozen training count's matrices are the port's."""
    from perfbench import port
    from repro_torch.models import lm
    cfg = harness.load_json(CFG / f"{name}.json")
    m = layout.dims(cfg)
    shell = lm.LM(port.arch_config(m, cfg, name), device="meta")
    got = {n: tuple(p.shape) for n, p in shell.named_parameters()}
    want = {leaf.name: leaf.shape for _, g in layout.groups(m) for leaf in g}
    assert got == want
    assert counts.matrix_params(m) == sum(
        p.numel() for p in shell.parameters() if p.dim() >= 2)
    assert layout.param_count(m) == sum(p.numel()
                                        for p in shell.parameters())
    assert shell.embed.table.dtype == torch.bfloat16
