"""Each per-layer reader's arithmetic on synthetic profiler intervals,
and the union and gaps they rest on."""

import types

import pytest

from lbmbench import devtrace, spec


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read


def session(device, window_s, cards, steps=0, units=0):
    """A stopped Session holding the given device events."""
    s = devtrace.Session(cards)
    s.device, s.window_s, s.steps, s.units = device, window_s, steps, units
    s.intervals = {c: [(a, b) for d, _, a, b in device if d == c]
                   for c in cards}
    s.busy = {c: devtrace.union(v) for c, v in s.intervals.items()}
    s.host = [("bench.run", 0.0, window_s)]
    return s


def run(s, nx=1024, ny=1024, spans=()):
    return types.SimpleNamespace(session=s, cards=s.cards, nx=nx, ny=ny,
                                 cells=nx * ny, spans=list(spans))


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert devtrace.union(iv) == pytest.approx(3.0)
    assert devtrace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]
    assert devtrace.union([]) == 0.0


@pytest.mark.parametrize("name", ["idle_share.solve", "idle_share.sweep"])
def test_idle_share_is_the_mean_over_cards(name):
    # card 0 busy 0.6 s of 1 s (overlapping kernels count once), card 1 0.2
    ev = [(0, "k", 0.0, 0.4), (0, "k", 0.3, 0.6), (1, "copy", 0.5, 0.7)]
    assert reader(name)(run(session(ev, 1.0, [0, 1]))) == pytest.approx(
        100 * (1 - 0.4))
    assert reader(name)(run(session([], 1.0, [0]))) is None


def test_launches_per_kstep_counts_every_device_event():
    ev = [(c, f"k{i}", i * 1e-3, i * 1e-3 + 1e-4) for c in (0, 1)
          for i in range(250)]
    s = session(ev, 1.0, [0, 1], steps=2000, units=1)
    assert reader("launches_per_kstep.solve")(run(s)) == pytest.approx(250)


def test_bound_share_from_shapes_and_steps():
    # one card busy 0.5 s for 20,000 steps of 1024^2: the operations bound
    # 94 * 2^20 * 2e4 / 67e12 s, over 0.5 s
    s = session([(0, "k", 0.0, 0.5)], 0.6, [0], steps=20000, units=1)
    got = reader("bound_share.solve")(run(s))
    assert got == pytest.approx(100 * 94 * 2**20 * 2e4 / 67e12 / 0.5)
    # four cards share the updates evenly, each busy a quarter as long
    ev = [(c, "k", 0.0, 0.125) for c in range(4)]
    s4 = session(ev, 1.0, [0, 1, 2, 3], steps=20000, units=1)
    assert reader("bound_share.solve")(run(s4)) == pytest.approx(got)
    # one step a call: the bytes bound (state in and out, the mask) wins
    s1 = session([(0, "k", 0.0, 1e-4)], 1e-3, [0], steps=1, units=1)
    assert reader("bound_share.solve")(run(s1)) == pytest.approx(
        100 * 2**20 * 73 / 3.35e12 / 1e-4)


@pytest.mark.parametrize("name,span", [("build_ms.sweep", "build"),
                                       ("write_ms.sweep", "write")])
def test_span_means(name, span):
    spans = [(span, 0.010), ("run", 1.0), (span, 0.030)]
    r = run(session([], 1.0, [0]), spans=spans)
    assert reader(name)(r) == pytest.approx(20.0)
    assert reader(name)(run(session([], 1.0, [0]))) is None


def test_breakdown_names_the_longest_gaps_and_ops():
    ev = [(0, "kernelA", 0.0, 0.3), (0, "kernelB", 0.5, 0.6),
          (0, "kernelA", 0.9, 1.0)]
    s = session(ev, 1.0, [0])
    s.host = [("bench.run", 0.0, 0.45), ("bench.write", 0.6, 1.0),
              ("aten::copy_", 0.7, 0.8)]
    b = s.breakdown()
    assert b["device_ops"][0] == ["kernelA", pytest.approx(0.4)]
    assert b["idle_gaps"][0] == ["cuda:0 bench.write: aten::copy_",
                                 pytest.approx(0.3)]
    assert b["idle_gaps"][1] == ["cuda:0 bench.run: host code",
                                 pytest.approx(0.2)]


def test_span_annotations_on_the_card_are_no_device_activity():
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, device, start, end):
            self.args = name, device, start, end

        def name(self):
            return self.args[0]

        def device_type(self):
            return self.args[1]

        def device_index(self):
            return 0

        def start_ns(self):
            return self.args[2]

        def duration_ns(self):
            return self.args[3] - self.args[2]

    events = [Ev("bench.run", DeviceType.CUDA, 0, 1000),
              Ev("kernel", DeviceType.CUDA, 100, 400),
              Ev("bench.run", DeviceType.CPU, 0, 1000),
              Ev("cudaLaunchKernel", DeviceType.CPU, 90, 95)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    device, host = devtrace._events(prof)
    assert device == [(0, "kernel", pytest.approx(100e-9),
                       pytest.approx(400e-9))]
    assert [h[0] for h in host] == ["bench.run", "cudaLaunchKernel"]
