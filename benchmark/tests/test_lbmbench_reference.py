"""The plain reference against the upstream code's own output and against
the program's plain step."""

import numpy as np
import torch

from lbmbench import compare, spec
from lbmbench.reference import Reference

GOLDEN = spec.ROOT / "tests" / "goldens" / "128x128.av_vels.dat"


def test_reproduces_the_upstream_128_golden_prefix():
    # the reference's own check: every value within 1 %
    cfg = spec.load_json(spec.HERE / "configs" / "ref-128.json")
    mask = spec.read_obstacles(spec.ROOT / cfg["obstacles"], 128, 128)
    ref = Reference(mask, cfg["density"], cfg["reynolds_dim"],
                    [cfg["omega"]], [cfg["accel"]])
    n = 400
    _, av = ref.run(ref.initial(), n)
    gold, faults = compare.read_av_vels(GOLDEN, 40000)
    assert faults == 0
    assert np.max(np.abs(av[0] - gold[:n]) / gold[:n]) < 0.01


def test_batch_members_are_independent():
    mask = np.zeros((16, 24), dtype=bool)
    mask[5:8, 4:7] = True
    one = Reference(mask, 0.1, 10, [1.83], [0.006])
    two = Reference(mask, 0.1, 10, [1.85, 1.83], [0.004, 0.006])
    f1, a1 = one.run(one.initial(), 60)
    f2, a2 = two.run(two.initial(), 60)
    assert torch.equal(f1[0], f2[1])
    np.testing.assert_array_equal(a1[0], a2[1])
    assert not np.array_equal(a2[0], a2[1])


def test_agrees_with_the_programs_plain_step(tiny):
    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.ops.step_torch import run_steps

    _, tmp = tiny
    mask = spec.read_obstacles(tmp / "obst.dat", 48, 32)
    p = LBMParams(nx=48, ny=32, max_iters=200, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85).with_free_cells(
                      int(mask.size - mask.sum()))
    ref = Reference(mask, 0.1, 10, [1.85], [0.005])
    f0 = ref.initial()
    f, av = ref.run(f0, 200)
    g, bv = run_steps(f0[0].clone(), torch.as_tensor(mask), p, 200)
    assert compare.gap(g.numpy(), f[0].numpy()) < 1e-5
    # the |u| sums cancel to ~1e-5 in the first steps: rounding, summed
    # in another order, reads ~1e-5 of the series' largest value
    assert compare.gap(bv.numpy(), av[0]) < 1e-4
    planes = ref.fields(f)[0].numpy()
    assert compare.field_gap(planes, planes) == 0.0
