"""The plain reference against the port's CPU routes (Kernel A's plain
version with bf16 operands, Kernel B's plain version, eager steps) at a
tiny size, and the lower-precision control, which the comparison must
fail."""
import pytest

from benchmark import control, harness

LIMITED = ["tanks_ballroom.train", "llff_fern.train",
           "tanks_ballroom.pose_opt", "tanks_ballroom.render"]


@pytest.mark.parametrize("workload", LIMITED)
def test_program_agrees_with_the_reference(tiny, workload):
    got = control.readings(workload, 11, "program", "cpu", tiny.bench,
                           tiny.bench_dir)
    assert got and all(v < 1e-4 for v in got.values()), got


@pytest.mark.parametrize("workload", LIMITED)
def test_the_bf16_route_stays_near_the_reference(tmp_path, workload):
    from conftest import Tiny

    tiny = Tiny(tmp_path, bf16=True)
    got = control.readings(workload, 11, "program", "cpu", tiny.bench,
                           tiny.bench_dir)
    assert got and all(v < 0.2 for v in got.values()), got


@pytest.mark.parametrize("workload", LIMITED)
def test_the_fp8_control_fails_the_limits(tiny, workload):
    lims = harness.limits(workload, tiny.bench_dir)
    if not lims:
        pytest.fail(f"no limits for {workload}")
    got = control.readings(workload, 12, "fp8", "cpu", tiny.bench,
                           tiny.bench_dir)
    correct, _ = harness.judge(got, lims)
    assert not correct, got
