"""Reading a profiler trace: busy time, kernels by name, idle gaps by what
the host was doing (a synthetic trace: this machine traces no device)."""

from types import SimpleNamespace

import pytest

from portbench import trace


class Event:
    def __init__(self, name, device, start, end, kind="", thread=1):
        self._v = (name, device, start, end, kind, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def activity_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def fake(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_busy_kernels_and_gaps():
    ms = 1_000_000
    events = [
        Event("portbench.window", False, 0, 100 * ms),
        Event("portbench.prepare", False, 0, 20 * ms),
        Event("aten::copy_", False, 20 * ms, 30 * ms),
        Event("portbench.decode_group", False, 20 * ms, 100 * ms),
        Event("cudaStreamSynchronize", False, 60 * ms, 95 * ms),
        Event("Memcpy HtoD (Pageable -> Device)", True, 25 * ms, 30 * ms,
              "gpu_memcpy"),
        Event("void conv3_ln_act_kernel<2>(...)", True, 30 * ms, 50 * ms,
              "kernel"),
        Event("band_attention_kernel", True, 45 * ms, 55 * ms, "kernel"),
        Event("band_attention_kernel", True, 70 * ms, 80 * ms, "kernel"),
        Event("qkv_depthwise_ln_kernel", True, 120 * ms, 130 * ms, "kernel"),
        Event("noise", False, 10 * ms, 90 * ms, thread=2),
        Event("portbench.decode_group", True, 20 * ms, 100 * ms,
              "gpu_user_annotation"),
    ]
    tr = trace.read(fake(events))
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.040)     # 25-55 and 70-80
    assert len(tr.kernels) == 3
    assert tr.kernel_seconds("conv3_ln_act") == pytest.approx(0.020)
    assert tr.kernel_seconds("band_attention") == pytest.approx(0.020)
    assert tr.kernel_seconds("qkv_depthwise_ln") == 0
    gaps = dict(tr.idle_gaps)
    # 0-25 cut at 20: 0-20 in prepare, 20-25 in decode_group's copy;
    # 55-70 and 80-100 in decode_group, their middles in the sync
    assert gaps["prepare|-"] == pytest.approx(0.020)
    assert gaps["decode_group|aten::copy_"] == pytest.approx(0.005)
    assert gaps["decode_group|cudaStreamSynchronize"] == pytest.approx(0.035)
    assert tr.device_ops[0][0] in ("void conv3_ln_act_kernel<2>(...)",
                                   "band_attention_kernel")


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.read(fake([Event("aten::mm", False, 0, 10)]))
