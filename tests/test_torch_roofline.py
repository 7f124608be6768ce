"""The port's roofline (``repro_torch.roofline.analysis``) against the
JAX package's: ``model_flops`` and ``hbm_traffic_model`` equal for every
config and input shape; ``roofline_terms`` equal when the reference's
constants are set to the port's H100 ones; the traffic model of the
recorded collectives (``collective_bytes``) gives the reference HLO
parser's numbers for the same ops with the boundary at 256, and charges
a group that crosses an 8-GPU NVLink node to the slow link. Exact."""
from __future__ import annotations

import numpy as np
import pytest

import repro.roofline.analysis as jroof
from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.analysis import Collective, collective_bytes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_hbm_model_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert roof.model_flops(cfg, shape) == jroof.model_flops(jcfg,
                                                                 jshape)
        for chips in (1, 256, 512):
            assert roof.hbm_traffic_model(cfg, shape, chips) == \
                jroof.hbm_traffic_model(jcfg, jshape, chips)


def test_h100_constants():
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.NVLINK_BW, roof.IB_BW,
            roof.NVLINK_DOMAIN) == (989e12, 3.35e12, 450e9, 50e9, 8)


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-236b",
                                  "mamba2-780m"])
def test_roofline_terms_equal_the_reference(arch, monkeypatch):
    """With the reference module's constants set to the port's, the
    terms and the report are the same, in both FLOP conventions."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", roof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", roof.NVLINK_BW)
    monkeypatch.setattr(jroof, "DCI_BW", roof.IB_BW)
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in SHAPES:
        for result in (
                {"devices": 256, "flops": 1e15, "hlo_bytes": 1e13,
                 "collective_bytes": {"all-reduce": 2e10,
                                      "intra_pod": 2e10}},
                {"devices": 512, "flops": 3e12, "hlo_bytes": 7e11,
                 "collective_bytes": {"all-gather": 1e10, "all-reduce": 4e9,
                                      "cross_pod": 6e9, "intra_pod": 8e9}},
                {"devices": 1, "flops": 1e20, "hlo_bytes": 1e12,
                 "collective_bytes": {}}):
            assert roof.roofline_terms(cfg, SHAPES[name], result) == \
                jroof.roofline_terms(jcfg, JSHAPES[name], result)
            assert roof.roofline_report(cfg, SHAPES[name], result) == \
                jroof.roofline_report(jcfg, JSHAPES[name], result)


def _groups(ids):
    return np.asarray(ids).reshape(1, -1)


def test_traffic_model_reproduces_the_hlo_parser():
    """The ops of ``tests/test_dryrun_integration.py``'s parser tests, as
    recorded collectives, with the pod boundary at 256: the same bytes
    by kind and by link as ``collective_bytes_from_hlo``."""
    hlo = """
  %ar = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[16,256]{1,0} all-gather(f32[4,256]{1,0} %y), dimensions={0}, replica_groups={{0,256}}
  %rs = f32[2,64]{1,0} reduce-scatter(f32[8,64]{1,0} %z), dimensions={0}
"""
    recs = [Collective("all-reduce", 8 * 128 * 2, _groups([0, 1, 2, 3])),
            Collective("all-gather", 16 * 256 * 4, _groups([0, 256])),
            Collective("reduce-scatter", 2 * 64 * 4, _groups([0]))]
    want = jroof.collective_bytes_from_hlo(hlo)
    assert collective_bytes(recs, domain=256) == want
    assert want["all-reduce"] == 2 * (8 * 128 * 2)
    assert want["cross_pod"] == 16 * 256 * 4

    hlo = ("  %ar = f32[64]{0} all-reduce(f32[64]{0} %x), "
           "replica_groups=[256,2]<=[2,256]T(1,0), to_apply=%add\n"
           "  %ag = f32[32]{0} all-gather(f32[2]{0} %y), dimensions={0}, "
           "replica_groups=[32,16]<=[512]\n")
    recs = [Collective("all-reduce", 64 * 4,
                       np.arange(512).reshape(2, 256).T),
            Collective("all-gather", 32 * 4,
                       np.arange(512).reshape(32, 16))]
    want = jroof.collective_bytes_from_hlo(hlo)
    assert collective_bytes(recs, domain=256) == want
    assert want["cross_pod"] == 2 * 64 * 4
    assert want["intra_pod"] == 32 * 4


def test_nvlink_domain_boundary():
    """A 16-rank group spans two 8-GPU nodes (slow link); a group inside
    one node stays on NVLink; a reduce-scatter moves G x its output;
    an unknown kind raises."""
    inside = Collective("reduce-scatter", 100, np.arange(16).reshape(2, 8))
    across = Collective("all-gather", 10, np.arange(16).reshape(1, 16))
    assert collective_bytes([inside]) == {"reduce-scatter": 800.0,
                                          "intra_pod": 800.0}
    assert collective_bytes([across]) == {"all-gather": 10.0,
                                          "cross_pod": 10.0}
    assert collective_bytes([across], domain=16) == {"all-gather": 10.0,
                                                     "intra_pod": 10.0}
    with pytest.raises(ValueError):
        collective_bytes([Collective("broadcast", 1, _groups([0, 1]))])
