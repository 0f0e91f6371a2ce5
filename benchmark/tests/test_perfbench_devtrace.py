"""The profiler's window read: the device's busy union, the idle gaps
named by the host's span, the launch calls and kernels."""

import types

import devtrace


class Ev:
    def __init__(self, name, start, dur, cuda=False):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def metadata_json(self):
        return ""


def prof_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_busy_union_gaps_and_counts():
    events = [
        Ev("bench.traced", 100, 1000),
        Ev("step.graph.B", 100, 200), Ev("cudaGraphLaunch", 150, 10),
        Ev("step.graph.C", 600, 300), Ev("cudaLaunchKernel", 610, 5),
        Ev("kernel_a", 200, 100, cuda=True), Ev("kernel_b", 250, 100, cuda=True),  # 200-350
        Ev("Memcpy DtoD", 700, 50, cuda=True),                                    # 700-750
        Ev("kernel_c", 1050, 200, cuda=True),                                     # 1050-1100 in
        Ev("kernel_d", 50, 20, cuda=True),                                        # before: out
    ]
    tr = devtrace.summarize(prof_of(events))
    assert tr.window_ns == 1000.0
    assert tr.busy_ns == 150 + 50 + 50
    assert tr.kernels == 4 and tr.launches == 2
    # idle: 100-200 (in B), 350-700 (in C from 600 on; the host at 350),
    # 750-1050 (C until 900), nothing after 1100
    assert [round(s * 1e9) for _, s in tr.gaps] == [350, 300, 100]
    assert [n for n, _ in tr.gaps] == ["host", "step.graph.C", "step.graph.B"]
    assert tr.top_ops[0] == ("kernel_c", 200e-9)
    assert [s for _, s in tr.top_ops] == sorted((s for _, s in tr.top_ops), reverse=True)


def test_device_only_profile_over_a_host_window():
    """A profile of the device's activity alone has no host span: the busy
    union over all its device operations, the window the host clock's,
    no gaps to name."""
    events = [Ev("cudaGraphLaunch", 150, 10), Ev("cudaLaunchKernel", 610, 5),
              Ev("kernel_a", 200, 100, cuda=True), Ev("kernel_b", 250, 100, cuda=True),
              Ev("Memcpy DtoD", 700, 50, cuda=True)]
    tr = devtrace.summarize(prof_of(events), window_ns=2000.0)
    assert tr.window_ns == 2000.0 and tr.busy_ns == 200
    assert tr.kernels == 2 and tr.launches == 2 and tr.gaps == []
