"""The control, the reference with every float input stored in bfloat16
in the program's place, comes out not correct, at a size a test holds;
and the reference itself is deterministic."""
from bench_tiny import SEED, tiny_cell


def test_control_fails_the_limits():
    from bench import check
    from bench.control import readings
    c = tiny_cell(seeds=2)
    (_, nums, _, _, _), = readings(c, "control", [SEED])
    ok, shown = check.verdict(nums, c.traffic["check"]["limits"])
    assert not ok, shown
    assert nums["route_diff"] == 0       # integers: the table is exact


def test_reference_agrees_with_itself():
    from bench import check
    from bench.ref import sim
    c = tiny_cell(seeds=2)
    lanes = check.sample_lanes(c.traffic, SEED)
    fab = sim.build_fabric(c.config)
    a = check.reference_view(c.config, c.traffic, SEED, 1, lanes, fab)
    b = check.reference_view(c.config, c.traffic, SEED, 1, lanes)
    nums = check.numbers(a, b, fab)
    assert all(v == 0 for v in nums.values()), nums
