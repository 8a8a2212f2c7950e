"""Render configuration.

The same frozen dataclass as ``tiny_renderer_tpu.config``: identical field
names, defaults and validation, so one config object (or its
``dataclasses.asdict``, see ``convert.config_from``) drives both packages in
the parity tests.  The port's frame path honours every raster knob below
except ``row_bands > 1`` (TPU on-chip memory banding), which it rejects
rather than silently ignoring.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All scene/render constants. Defaults reproduce the reference."""

    width: int = 800   # src/main.rs:6
    height: int = 800  # src/main.rs:7

    # Viewport depth range; z is mapped into [0, depth] (shader.rs:210-218).
    depth: float = 255.0
    # Perspective row coefficient w' = 1 + coef * z (shader.rs:204-208).
    projection_coef: float = -1.0 / 5.0

    # Shadow pipeline constants (shader.rs:776-779).
    shadow_bias: float = 1.0
    shadow_dim: float = 0.3

    # Occlusion pipeline constants (shader.rs:916-920).
    occlusion_samples: int = 16
    occlusion_step: float = 0.02
    occlusion_threshold: float = 1.0
    occlusion_depth_scale: float = 20.0

    # Specular pipeline constant (shader.rs:521).
    specular_scale: float = 0.6

    # Collapse duplicate shadow-map indices in the occlusion probe (JAX only).
    occlusion_dedup: bool = False

    # Raster screen tile (one CUDA thread block per tile in the port).  The
    # multiple-of-128 / multiple-of-8 validation is the TPU's, kept so one
    # config drives both packages.
    tile_h: int = 32
    tile_w: int = 128
    # Compact real incidences before the binning sort (same CSR result).
    binning_compact: bool = False
    # Indirect CSR records: (T, lanes) table + (cap,) sorted triangle ids;
    # False gathers the records into CSR order, (cap, lanes).
    csr_indirect: bool = True
    # Raster-emitted per-strip coverage plane (K1 emit_strips).
    strip_mask: bool = False
    # Global cap on (tile, triangle) incidences; None = max(4*T, 4096).
    max_incidences: int | None = None
    # Max tile span of one triangle's bbox (rows x cols of tiles).
    max_span_y: int = 8
    max_span_x: int = 4
    # Triangle block of the JAX dense raster (not ported).
    tri_block: int = 64
    # Triangles per depth-loop iteration of the TPU kernel; the result is
    # invariant to it and the CUDA kernel has no such knob.
    raster_group: int = 16
    # Both passes' rasters in one launch (K2).
    fuse_passes: bool = False
    # int16 winning-index target (K1 int16 mode).
    idx_int16: bool = False
    # Strip shade writeback as one packed RGB word per pixel.
    strip_pack_words: bool = True
    # Strip-compacted shading of covered strip_len-pixel strips.
    compact_shade: bool = True
    # Strips per shade batch in the JAX while_loop; the port shades every
    # covered strip in one batch (same pixels).
    strip_batch: int = 512
    # Kernel-interpolated varying planes for the strip shade (K1 phase 2).
    strip_planes: bool = False
    strip_len: int = 16

    # Scale-out knobs of the JAX sharded paths (not ported).
    shard_triangles: bool = False
    row_bands: int = 0
    replicate_pass1: bool = False

    # Tile-swizzled packed texture plane (a pure permutation of texels).
    tex_tile: int = 0
    # Tile-swizzled shade copy of the shadow map (a pure permutation).
    shadow_tile: int = 0

    # Camera/light orbit speeds in rad/s (src/app.rs:12-13).
    camera_speed: float = 3.0
    light_speed: float = 3.0

    # Apply the per-pipeline tuned defaults at render entry
    # (resolve_for_pipeline); False keeps every field as given.
    auto_tune: bool = True

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid frame size {self.width}x{self.height}")
        if self.tile_w % 128 != 0 or self.tile_w < 128:
            raise ValueError(f"tile_w must be a positive multiple of 128, got {self.tile_w}")
        if self.tile_h % 8 != 0 or self.tile_h < 8:
            raise ValueError(f"tile_h must be a positive multiple of 8, got {self.tile_h}")
        if self.max_span_y < 1 or self.max_span_x < 1:
            raise ValueError("binning span caps must be >= 1")
        if self.max_incidences is not None and self.max_incidences < 8:
            raise ValueError("max_incidences must be >= 8")
        if self.occlusion_samples < 1:
            raise ValueError("occlusion_samples must be >= 1")
        if self.strip_batch < 1:
            raise ValueError("strip_batch must be >= 1")
        if self.raster_group < 1:
            raise ValueError("raster_group must be >= 1")
        if self.row_bands < 0:
            raise ValueError("row_bands must be 0 (auto) or >= 1")
        if self.strip_len < 1 or (self.strip_batch * self.strip_len) % 128 != 0:
            raise ValueError(
                "strip_len must be >= 1 with strip_batch * strip_len a "
                f"multiple of 128, got {self.strip_batch} x {self.strip_len}"
            )
        for knob in ("tex_tile", "shadow_tile"):
            v = getattr(self, knob)
            if v < 0 or (v & (v - 1)) != 0:
                raise ValueError(
                    f"{knob} must be 0 or a power of two, got {v}"
                )

    def resolve(self, pipeline: str) -> "RenderConfig":
        """Alias for resolve_for_pipeline(self, pipeline)."""
        return resolve_for_pipeline(self, pipeline)

    @property
    def padded_width(self) -> int:
        return -(-self.width // self.tile_w) * self.tile_w

    @property
    def padded_height(self) -> int:
        return -(-self.height // self.tile_h) * self.tile_h

    @property
    def tiles_x(self) -> int:
        return self.padded_width // self.tile_w

    @property
    def tiles_y(self) -> int:
        return self.padded_height // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


# Per-pipeline tuned defaults, each an atomic group (applied only while every
# field of the group sits at its class default).  These were chosen for the
# JAX package on its TPU; the port keeps them so both packages resolve a
# config identically.  None of them changes a pixel.
PIPELINE_TUNED_DEFAULTS: dict = {
    "shadow": {"tex_tile": 16},
    "phong": {"tex_tile": 16},
    "default": {"tex_tile": 16},
    "normal_map": {"tex_tile": 16},
    "darboux": {"tex_tile": 16},
    "occlusion": {"strip_len": 8, "strip_batch": 1024},
}

# Resolution-conditional span caps (pipeline-independent; applied only at the
# default projection).  A scene whose triangles exceed them loses coverage
# deterministically and reports it through `overflow`.
SPAN_TUNED_BY_RESOLUTION: tuple = (
    (800, {"max_span_y": 4, "max_span_x": 2}),
    (1200, {"max_span_y": 5, "max_span_x": 3}),
)


def resolve_for_pipeline(config: RenderConfig, pipeline: str) -> RenderConfig:
    """Apply PIPELINE_TUNED_DEFAULTS for `pipeline` and the span caps for the
    resolution to fields still at their class defaults.  Idempotent; no-op
    when config.auto_tune is False."""
    if not config.auto_tune:
        return config
    defaults = {f.name: f.default for f in dataclasses.fields(RenderConfig)}

    def apply(cfg, group):
        if not group or any(getattr(cfg, k) != defaults[k] for k in group):
            return cfg
        return dataclasses.replace(cfg, **group)

    config = apply(config, PIPELINE_TUNED_DEFAULTS.get(pipeline))
    if config.projection_coef == defaults["projection_coef"]:
        for bound, group in SPAN_TUNED_BY_RESOLUTION:
            if max(config.width, config.height) <= bound:
                config = apply(config, group)
                break
    return config
