"""Scene: the host-side API mirroring the reference's `Scene` struct
(src/scene.rs:25-149) and ``tiny_renderer_tpu.scene``.

Geometry and textures live on the scene's device; `render()` runs one frame
there.  The getters fetch and convert like the reference (u8 casts,
vertical flip at presentation, scene.rs:92-125).  The public calls record
the tracer's host spans (utils/timing.py): scene.render (scene.stage, then
the frame graph's graph.replay and frame.clone), scene.fetch (fetch.wait,
fetch.copy) and scene.render_sequence (sequence.issue: the replays and, on
CUDA, each frame's copy to pinned host memory issued, with
sequence.alloc, the pinned host frames' allocation, and sequence.angles,
the angles' copies to the device, inside it; sequence.wait: the
render finished; sequence.copy: the copies' unhidden tail; the counters
sequence.frames, the frames it returned, and sequence.overlapped, those
whose copy was issued before the burst's last replay).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .assets.model import Model
from .config import RenderConfig
from .convert import scene_arrays, to_tensor
from .ops import mathlib as ml
from .ops.vertex import expand_geometry
from .pipelines.frame import (
    BACKENDS, PIPELINES, make_burst_fn, make_frame_fn, prepack_textures)
from .utils import timing


class Scene:
    """A model, a pipeline and camera/light state, rendered on `device`
    ("cuda" runs the CUDA raster kernel, "cpu" its plain torch twin) by the
    raster `backend`: "kernel" (the binned tile raster) or "dense" (every
    triangle at every pixel, the JAX package's "jnp"; frame.BACKENDS)."""

    def __init__(self, model: Model, pipeline_name: str = "default",
                 config: RenderConfig | None = None, device="cuda",
                 vertex_attrs: dict | None = None, backend: str = "kernel"):
        if pipeline_name not in PIPELINES:
            raise ValueError(
                f"Provided pipeline name is not supported! ({pipeline_name!r}; "
                f"expected one of {sorted(PIPELINES)})"
            )
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        # The stored config is the resolved one, so the texture prepack and
        # the frame function agree on layouts.
        self.config = (config or RenderConfig()).resolve(pipeline_name)
        self.pipeline_name = pipeline_name
        self.device = torch.device(device)
        self.backend = backend
        self.model = model

        mesh = model.mesh
        geom, textures = scene_arrays(
            {
                "positions": mesh.positions, "tex_coords": mesh.tex_coords,
                "normals": mesh.normals, "pos_idx": mesh.pos_idx,
                "tex_idx": mesh.tex_idx, "normal_idx": mesh.normal_idx,
            },
            {
                "texture": model.texture, "normal_map": model.normal_map,
                "normal_map_tangent": model.normal_map_tangent,
                "specular_map": model.specular_map,
            },
            self.device,
        )
        # Per-triangle attributes expanded and textures packed once, not
        # per frame.
        self._geom = expand_geometry(geom)
        # Custom per-vertex attributes for registered pipelines that declare
        # "attr:<name>" varyings (register_pipeline): each a
        # (num_triangles, 3, k) float array, per triangle corner.
        for aname, arr in (vertex_attrs or {}).items():
            key = aname if aname.startswith("attr:") else f"attr:{aname}"
            self._geom[key] = to_tensor(np.asarray(arr, np.float32), self.device)
        self._textures = prepack_textures(textures, pipeline_name, tile=self.config.tex_tile)
        self._frame_fn = make_frame_fn(pipeline_name, self.config, backend)

        # Scene state (reference defaults, scene.rs:66-69).
        self._light_direction = np.array([0.0, 0.0, -1.0], np.float32)
        self._look_from = np.array([0.0, 0.0, 1.0], np.float32)
        self._look_at = np.array([0.0, 0.0, 0.0], np.float32)
        self._up = np.array([0.0, 1.0, 0.0], np.float32)
        self._out = None
        self._overflow_warned = False

    # -- reference API ------------------------------------------------------

    def clear(self):
        """Frames are recomputed from the scene state; kept for API parity
        with scene.rs:128-137."""
        self._out = None

    def set_light_direction(self, light_direction):
        self._light_direction = np.asarray(light_direction, np.float32)

    def set_camera(self, look_from, look_at, up):
        self._look_from = np.asarray(look_from, np.float32)
        self._look_at = np.asarray(look_at, np.float32)
        self._up = np.asarray(up, np.float32)

    def render(self):
        """Render a frame at the scene state (on CUDA the frame function's
        replayed graph): dict(frame, z, shadow, overflow) on the device."""
        with timing.span("scene.render"):
            with timing.span("scene.stage"):
                vecs = np.stack([self._light_direction, self._look_from, self._look_at, self._up])
                staged = torch.from_numpy(vecs)
                if self.device.type == "cuda":
                    # One non-blocking copy from pinned memory: the host does not
                    # wait for the device (a pageable copy would).
                    staged = staged.pin_memory()
                views = staged.to(self.device, non_blocking=True)
            self._out = self._frame_fn(self._geom, self._textures, *views)
        return self._out

    def synchronize(self):
        """Wait until the device has finished the last render."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # The JAX Scene's name for it (tiny_renderer_tpu/scene.py).
    block_until_ready = synchronize

    def render_sequence(self, camera_angles, light_angles) -> np.ndarray:
        """Render an orbit burst (src/app.rs:200-207) and return the frames as
        (N, H, W, 3) u8, presentation-flipped like get_frame_buffer.

        On CUDA the frames are a view of one pinned host tensor, each frame
        copied there while the next renders.  Torch's caching host allocator
        gives the block out again once the caller drops the array, so a
        caller that keeps frames across calls keeps pinned memory."""
        cams = np.asarray(camera_angles, np.float32)
        with timing.span("scene.render_sequence"):
            with timing.span("sequence.issue"):
                with timing.span("sequence.alloc"):
                    host = (torch.empty((len(cams), self.config.height, self.config.width, 3),
                                        dtype=torch.uint8, pin_memory=True)
                            if self.device.type == "cuda" else None)
                burst = make_burst_fn(self.pipeline_name, self.config, keep_frames=True,
                                      backend=self.backend)
                with timing.span("sequence.angles"):
                    cam_t = to_tensor(cams, self.device)
                    light_t = to_tensor(np.asarray(light_angles, np.float32), self.device)
                out = burst(self._geom, self._textures, cam_t, light_t, host_frames=host)
            with timing.span("sequence.wait"):
                self._warn_if_overflowed(out["overflow"])
            with timing.span("sequence.copy"):
                if "copied" in out:
                    out["copied"].synchronize()
                frames = out["frames"].cpu().numpy()[:, ::-1]
            timing.count("sequence.frames", len(frames))
            timing.drain()
        return frames

    @property
    def overflowed(self) -> bool:
        """True if the last render hit a binning coverage cap."""
        return bool(self._require_render()["overflow"])

    def get_frame_buffer(self) -> np.ndarray:
        """(H, W, 3) u8, vertically flipped so row 0 is the top of the world
        (scene.rs:92-97)."""
        with timing.span("scene.fetch"):
            out = self._require_render()
            with timing.span("fetch.wait"):
                self._warn_if_overflowed(out["overflow"])
            with timing.span("fetch.copy"):
                frame = out["frame"].cpu().numpy()[::-1]
            timing.drain()
        return frame

    def get_z_buffer(self) -> np.ndarray:
        """Grayscale u8 debug view of the z-buffer (scene.rs:101-111)."""
        return self._gray(self._require_render()["z"])

    def get_shadow_buffer(self) -> np.ndarray:
        """Grayscale u8 debug view of the shadow buffer (scene.rs:115-125)."""
        return self._gray(self._require_render()["shadow"])

    # -----------------------------------------------------------------------

    @staticmethod
    def _gray(plane):
        g = ml.rust_f32_to_u8(plane).cpu().numpy()
        return np.repeat(g[::-1, :, None], 3, axis=2)

    def _warn_if_overflowed(self, overflow) -> None:
        """One-time warning where a host fetch is paid anyway."""
        if self._overflow_warned or not bool(overflow.any()):
            return
        self._overflow_warned = True
        warnings.warn(
            "render hit a binning coverage cap (coverage was truncated "
            "deterministically): raise RenderConfig.max_span_y/max_span_x "
            "(or max_incidences if set), or pass auto_tune=False to keep "
            "the wider class-default span grid",
            RuntimeWarning,
            stacklevel=3,
        )

    def _require_render(self):
        if self._out is None:
            self.render()
        return self._out
