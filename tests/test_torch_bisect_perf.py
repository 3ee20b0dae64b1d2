"""detzero_tpu_torch/tools/bisect_perf.py on the CPU at the tiny scale: its
three groups print one JSON line a stage with finite times and append
them to the output file; BISECT_ONLY keeps the named stages; the card is
refused where there is none.  The card's run is chip_smoke.py phase 18's
prefix and the command given in the README."""

import json
import math

import pytest
import torch

from detzero_tpu_torch.tools import bisect_perf

MICRO = {"sort_points_argsort160k", "sort_ids_120k", "argsort_160k_i32",
         "sort_160k_i32_unstable", "sortkv_160k_i32", "sort_120k_i32",
         "ss_searchsorted_3.2M_in_120k", "ss_searchsorted_9x120k",
         "lut_build_64k_into_2.26M", "lut_small_450k_from_2.26M",
         "gather_only_3.2Mx16", "gather_only_bf16", "gather_only_3.2Mx128",
         "gather2d_120k_rows_640", "scatter_add_160k_into_2.6M",
         "segsum_sorted_160k_into_2.6M", "segsum_sorted_160kx5_into_4.8M",
         "segsum_sorted_160kx1_into_4.8M", "segmin_sorted_160k_into_120k",
         "scatter_rows_120kx16_into_2.6M", "scatter_max_dups_160k_into_2.26M",
         "scatter_add_dups_160k_into_1504",
         "scatter_add_dups_160kx8_into_4.8M",
         "scatter_set_unique_100kx8_into_4.8M",
         "scatter_add_unique_100kx8_into_4.8M", "gather_4.8Mx8_from_100k",
         "cumsum_2.26M", "cumsum_2.26M_i32", "topk_65536_of_2.26M",
         "unique_capped_120k", "nms_1024", "bev2d_head_dense",
         "densify_final_bev", "pallas_conv_l0_rowpad",
         "pallas_conv_l0_sliding", "pallas_conv_l0_fusedbn",
         "pallas_conv_l0_down", "pallas_conv_l1_rowpad",
         "pallas_conv_l3_rowpad", "pallas_dw_l0"}
PREFIX = {"prefix_voxelize", "prefix_tables(voxelize+plan)",
          "prefix_backbone+head(prebuilt_plan)", "prefix_forward",
          "prefix_predict(+decode+nms)"}
FUSEGAP = {"fg_tables", "fg_vox_table", "fg_vox_baseplan", "fg_vox_rowpad",
           "fg_net_arg", "fg_forward", "fg_backbone_l0", "fg_backbone_l1",
           "fg_backbone_l2", "fg_backbone_l3", "fg_backbone"}
ARGS = ["--device", "cpu", "--scale", "tiny", "--iters", "1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bisect") / "bisect_perf.json"
    return bisect_perf.main(["micro", "prefix", "fusegap", *ARGS,
                             "--output", str(out)]), out


@pytest.mark.parametrize("group,names,modes", [
    ("micro", MICRO, (None,)), ("prefix", PREFIX, ("principal", "union")),
    ("fusegap", FUSEGAP, ("principal", "union"))])
def test_one_line_a_stage(run, capsys, group, names, modes):
    lines, _ = run
    recs = [r for r in lines if r["group"] == group]
    got = sorted((r["stage"], r.get("site_mode")) for r in recs)
    assert got == sorted((n, m) for n in names for m in modes)
    for r in recs:
        assert r["scale"] == "tiny" and r["iters"] == 1
        assert math.isfinite(r["ms"]) and r["ms"] > 0, r
        assert math.isfinite(r["per_iter_ms"]) and r["per_iter_ms"] > 0, r


def test_lines_printed_and_appended(run, tmp_path, capsys, monkeypatch):
    lines, out = run
    assert json.loads(out.read_text()) == lines
    monkeypatch.setenv("BISECT_ONLY", "sort_ids,nms")
    more = bisect_perf.main(["micro", *ARGS, "--output", str(out)])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed[0] == {"device": "cpu", "groups": ["micro"],
                          "scale": "tiny"}
    assert printed[1:] == more
    assert [r["stage"] for r in more] == ["sort_ids_120k", "nms_1024"]
    assert json.loads(out.read_text()) == lines + more


def test_card_refused_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bisect_perf.main(["micro"])
