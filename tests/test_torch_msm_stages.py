"""The port's MSM stage harness (zkpoa_tpu_torch/experiments/msm_stages.py)
on the CPU: every stage is recorded, and the MSM total equals sum s_i P_i
computed with the JAX package's host arithmetic (zkpoa_tpu.fields.bn254)
from the harness's own numpy-seeded inputs. Tolerance: exact equality of
the affine point."""

import json
import math

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu.fields import bn254 as jb
from zkpoa_tpu_torch.experiments import msm_stages as H

torch.set_num_threads(1)

LIBRARY = ("g_take_rows", "g_take_xy_rows", "g_take_limbmaj", "g_take_pad128", "g_take_sorted")
KERNELS = {"g_vmem_pallas": "gather_smem_rows", "g_vmem_take": "gather_vec",
           "g_vmem_take_2p13": "gather_vec", "g_vmem_take_2p20": "gather_vec",
           "g_dma_pallas": "gather_async", "g_dma_msm": "gather_async"}
STAGES = ("digits", "plan(sort)", *LIBRARY, *KERNELS, "full_group", "reduce", "msm")


def test_harness_records_every_stage_and_an_exact_msm(tmp_path):
    out = tmp_path / "stages.json"
    assert H.main(["10", "5", "--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert (res["log_n"], res["c"], res["n"], res["device"]) == (10, 5, 1024, "cpu")
    assert (res["nw"], res["nb"]) == (51, 16) and res["occupancy"] > 0
    assert res["piece"] > 0 and res["pieces"] >= res["nw"] and res["combine_depth"] >= 1
    for stage in STAGES:
        assert math.isfinite(res[stage]["warm_s"]) and res[stage]["best_s"] >= 0, stage
    for stage in (*LIBRARY, *KERNELS):
        assert res[stage]["mrows_s"] > 0, stage
    assert res["g_take_pad128"]["rows"] == 1024 // 8
    for stage, kernel in KERNELS.items():
        assert res[stage]["kernel"] == kernel and res[stage]["library_best_s"] >= 0
    assert res["g_vmem_pallas"]["table"] == [1024, 16] and res["g_vmem_pallas"]["rows"] == 1 << 15
    assert res["g_vmem_take_2p13"]["table"] == [1024, 16]
    assert res["g_vmem_take_2p20"]["table"] == [1024, 16]
    assert res["g_vmem_take_2p20"]["rows"] == 1 << 20
    assert res["g_dma_pallas"]["table"] == [1024, 128] and res["g_dma_pallas"]["rows"] == 1 << 14
    assert res["g_dma_msm"]["table"] == [1024, 16] and res["g_dma_msm"]["rows"] == 1024
    assert {"g_take_tr", "kernel_64r"} <= set(res["no_counterpart"])
    assert res["msm"]["exact"] is True

    gens, scal = H.host_inputs(10)
    want = None
    for g, s in zip(gens, scal):
        want = jb.g1_add(want, jb.g1_mul(jb.g1_mul(jb.G1_GEN, g), s))
    assert (int(res["msm"]["x"]), int(res["msm"]["y"])) == want


def test_harness_defaults_to_the_card_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would be the full 2^20 harness")
    out = tmp_path / "stages.json"
    assert H.main(["8", "5", "--out", str(out)]) == 1
    assert not out.exists()
