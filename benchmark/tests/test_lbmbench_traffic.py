"""The seeded draws of the traffic: the same seed gives the same draws,
inside the config's ranges, for seeds past 32 bits too."""

import numpy as np
import pytest

from lbmbench import spec
from lbmbench.cell import Reservoir

CONFIGS = ["ref-1024", "ref-128"]
SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


def draws(config, seed, n=20):
    rng = spec.rngs(seed)[0]
    return [spec.draw(rng, config) for _ in range(n)]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_repeat_and_stay_in_range(name, seed):
    config = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    got = draws(config, seed)
    assert got == draws(config, seed)
    (olo, ohi), (alo, ahi) = (config["draws"]["omega"],
                              config["draws"]["accel_scale"])
    for omega, accel in got:
        assert olo <= omega <= ohi
        assert alo * config["accel"] <= accel * (1 + 1e-7)
        assert accel <= ahi * config["accel"] * (1 + 1e-7)
        assert omega == float(np.float32(omega))
        assert accel == float(np.float32(accel))
    assert len(set(got)) == len(got)
    assert draws(config, seed + 1) != got


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_reservoir_repeats_and_fills_its_slots(k, seed):
    def picks():
        pick = Reservoir(k, spec.rngs(seed)[1])
        return [pick.offer(i) for i in range(200)]

    got = picks()
    assert got == picks()
    assert got[:k] == list(range(k))
    assert {s for s in got if s is not None} == set(range(k))
    assert sum(s is not None for s in got[k:]) >= 1


@pytest.mark.parametrize("name", ["long", "sweep"])
def test_each_traffic_mix_names_a_kind_that_exists(name):
    traffic = spec.load_json(spec.HERE / "traffic" / f"{name}.json")
    module = spec.load_module(spec.HERE / "kinds" / f"{traffic['kind']}.py")
    assert callable(module.run)
    assert traffic["trace_seconds"] > 0
