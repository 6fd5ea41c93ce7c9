"""The control at a tiny size: the reference one precision below the
configuration's, in the program's place, reads well above the program and
comes out not correct under the cell's own limits, by the check's own
verdict. On the card the same comparison runs at the cells' sizes
(``python3 -m port_bench.control``), the float32 cell's TF32 control with
it: TF32 exists only on the card."""

from __future__ import annotations

from port_bench import control, run

from . import tiny


def test_fp8_control_reads_above_the_bf16_program():
    kept = {}
    res = run.run_cell("serve-bf16-sat", 77, 6.0, False, device="cpu",
                       overrides=tiny.overrides("serve-bf16-sat", dtype="bfloat16"),
                       on_served=lambda served, ctx: kept.update(
                           c=control.control_readings(served, ctx)))
    res.pop("_run")
    program, low = res["check"], kept["c"]
    assert res["correct"], program
    assert low["precision"] == "fp8"
    assert set(low["numbers"]) == set(program) == {"token_gap", "frame_flips"}
    assert low["correct"] is False, low["numbers"]
    assert low["token_gap"] > 3 * program["token_gap"]["value"]
