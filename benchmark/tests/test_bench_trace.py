"""The trace arithmetic on a synthetic trace, and the roofline's bytes."""

import re

import pytest

from benchmark import roofline, tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    return [
        ev(tracing.WINDOW, "user_annotation", 100.0, 1000.0),
        ev("before", "kernel", 0.0, 150.0),                       # clipped to [100, 150]
        ev("raster_kernel<true, false>(Pass)", "kernel", 200.0, 100.0),
        ev("other", "kernel", 250.0, 100.0),                      # overlaps: counted once
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 500.0, 200.0),
        ev("Memset", "gpu_memset", 1050.0, 100.0),                # clipped to [1050, 1100]
        ev("gpu_user_annotation", "gpu_user_annotation", 100.0, 1000.0),  # not device work
        ev("cudaGraphLaunch", "cuda_runtime", 360.0, 130.0),
        ev("aten::copy_", "cpu_op", 700.0, 300.0),
        ev("flow", "ac2g", 0.0, 0.0) | {"ph": "s"},
    ]


def test_union_and_window():
    t = tracing.summarize(synthetic(), frames=2)
    # busy: [100,150] + [200,350] + [500,700] + [1050,1100] = 50 + 150 + 200 + 50 = 450 us
    assert t.busy_s == pytest.approx(450e-6)
    assert t.window_s == pytest.approx(1000e-6)
    assert [n for n, _ in t.kernels] == ["before", "raster_kernel<true, false>(Pass)", "other"]
    # gaps: [150,200] 50, [350,500] 150, [700,1050] 350: longest first, named by the host
    assert [g[0] for g in t.idle_gaps] == ["aten::copy_", "cudaGraphLaunch", "host"]
    assert [g[1] for g in t.idle_gaps] == pytest.approx([350e-6, 150e-6, 50e-6])
    assert t.device_ops[0][0] == "Memcpy DtoH (Device -> Pageable)"


def test_per_frame_seconds():
    t = tracing.summarize(synthetic(), frames=2)
    assert tracing.per_frame_seconds(t, roofline.RASTER_KERNELS) == pytest.approx(50e-6)
    assert tracing.per_frame_seconds(t, re.compile("absent")) is None
    assert tracing.per_frame_seconds(None, roofline.RASTER_KERNELS) is None


def test_no_window_or_no_device_work():
    assert tracing.summarize([ev("k", "kernel", 0, 10)]) is None
    assert tracing.summarize([ev(tracing.WINDOW, "user_annotation", 0, 10)]) is None


def test_raster_bytes():
    # two planes of 800x800 4-byte pixels, two passes over 5,096 triangles' 36 bytes
    assert roofline.raster_bytes(800, 800, 5096) == 2 * 800 * 800 * 4 + 2 * 5096 * 36
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, flops=67e12) == pytest.approx(1.0)


def test_raster_kernel_names():
    assert roofline.RASTER_KERNELS.search("void (anonymous namespace)::raster_kernel<true, false>(x)")
    assert roofline.RASTER_KERNELS.search("void (anonymous namespace)::raster_fused_kernel(x)")
    assert not roofline.RASTER_KERNELS.search("raster_twin")


def test_metric_readers_return_nothing_without_readings():
    from benchmark import harness

    r = harness.Readings(None, {"width": 8, "height": 8}, 10, {}, None)
    for name in ("device_idle_share.burst", "kernels_per_frame.burst", "raster_device_ms.burst",
                 "raster_roofline", "host_issue_ms.interactive", "blit_ms.interactive"):
        assert harness.metric_reader(name).read(r) is None


def test_roofline_share_reader():
    from benchmark import harness

    t = tracing.summarize(synthetic(), frames=2)
    r = harness.Readings(None, {"width": 800, "height": 800}, 5096, {}, t)
    share = harness.metric_reader("raster_roofline").read(r)
    least = roofline.least_seconds(roofline.raster_bytes(800, 800, 5096))
    assert share == pytest.approx(100 * least / 50e-6)
