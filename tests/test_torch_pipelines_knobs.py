"""Torch port: the raster knobs on the six pipelines beside shadow.

Every knob renders exactly the pipeline's default port frame: the raster
resolve is lexicographic and the shading expressions are shared, so a knob
that changes a pixel is a bug (test_torch_knobs.py holds shadow to the
same).  Rendered with needs_z=False so fuse_passes engages where its gate
allows.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_frame import CFG
from test_torch_pipelines import MAPS, NEW_PIPELINES, port_frame
from tiny_renderer_tpu_torch.ops import raster_cuda

KNOBS = {
    "fullplane": dict(compact_shade=False),
    "planes": dict(strip_planes=True),
    "mask": dict(strip_mask=True),
    "i16": dict(idx_int16=True),
    "nocsr": dict(csr_indirect=False),
    "nopack": dict(strip_pack_words=False),
}
CASES = [pytest.param(p, "same", k, KNOBS[k], id=f"{p}-{k}") for p in NEW_PIPELINES for k in KNOBS]
CASES += [
    pytest.param("occlusion", "same", "fuse", dict(fuse_passes=True), id="occlusion-fuse"),
    pytest.param("occlusion", "same", "dedup", dict(occlusion_dedup=True), id="occlusion-dedup"),
    pytest.param("darboux", "mixed", "fullplane", KNOBS["fullplane"], id="darboux-mixed-dims-fullplane"),
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.cache
def default_frame(pipeline, maps):
    return port_frame(pipeline, MAPS[maps], needs_z=False)


@pytest.mark.parametrize("pipeline,maps,name,knobs", CASES)
def test_knob_bit_identical(pipeline, maps, name, knobs):
    want = default_frame(pipeline, maps)
    got = port_frame(pipeline, MAPS[maps], dataclasses.replace(CFG, **knobs), needs_z=False)
    np.testing.assert_array_equal(got["frame"], want["frame"])
    np.testing.assert_array_equal(got["shadow"], want["shadow"])
    assert bool(got["overflow"]) == bool(want["overflow"])
    assert (got["frame"] > 0).any(-1).mean() > 0.02


@pytest.mark.parametrize("pipeline,knobs,modes", [
    ("occlusion", dict(fuse_passes=True), {"fused"}),
    ("darboux", dict(strip_planes=True), set()),
    ("darboux", dict(compact_shade=False), {"planes"}),
    ("occlusion", dict(strip_mask=True, strip_planes=True), {"strips", "planes"}),
])
def test_knob_takes_its_kernel_mode(monkeypatch, pipeline, knobs, modes):
    """Each knob reaches the raster mode it names: K2 for occlusion's
    fuse_passes, phase 2 for the varying planes (never for darboux's strip
    shade, whose per-triangle constants keep the attribute gather), the
    strip plane at occlusion's strip_len 8."""
    seen = set()
    raster, fused = raster_cuda.rasterize, raster_cuda.rasterize_fused

    def spy(*a, **k):
        seen.update({"planes"} if k.get("spec") else set())
        seen.update({"strips"} if k.get("emit_strips") else set())
        if k.get("emit_strips"):
            assert k["emit_strips"] == (8 if pipeline == "occlusion" else 16)
        return raster(*a, **k)

    monkeypatch.setattr(raster_cuda, "rasterize", spy)
    monkeypatch.setattr(raster_cuda, "rasterize_fused", lambda *a, **k: seen.add("fused") or fused(*a, **k))
    port_frame(pipeline, MAPS["same"], dataclasses.replace(CFG, **knobs), needs_z=False)
    assert seen == modes
