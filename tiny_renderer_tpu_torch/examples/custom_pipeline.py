"""Registering a custom shader pipeline (``examples/custom_pipeline.py``).

The seven built-in pipelines mirror the reference (shader.rs:100-109); this
example adds two more without touching the renderer's internals:

* "toon" — a cel shader that quantizes the Gouraud intensity into bands,
  composed purely from the built-in varying vocabulary; and
* "glow" — the same texture lit by a USER vertex attribute: a varying
  named "attr:glow" declares a (T, 3, 1) per-corner float plane the
  caller supplies (here from the model's height), which the renderer
  interpolates exactly like uv.

Registered names work with Scene, render_frame/render_burst, the CLI
(when registered before build_arg_parser) and the frame server.

Run:  python -m tiny_renderer_tpu_torch.examples.custom_pipeline [asset_dir] [out.png]
      (also writes <out>-glow.png; without asset_dir, the procedural
      stand-in of the flagship model)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import mathlib as ml
from ..pipelines.shaders import sample_frag

TOON_SPEC = (("uv", 2, "interp"), ("intensity", 1, "interp"))
GLOW_SPEC = (("uv", 2, "interp"), ("attr:glow", 1, "interp"))


def shade_toon(frag, uniforms, textures, config):
    """Cel shading: texture color scaled by intensity snapped to 4 bands.

    The shade signature: frag carries the varyings declared at
    registration ("uv" arrives pre-resolved for sample_frag, "intensity"
    per fragment) plus "x"/"y"; everything is a tensor on the render
    device."""
    color = sample_frag(textures, frag, ("texture",))["texture"]
    t = torch.ceil(frag["intensity"].clamp(0.0, 1.0) * 4.0) / 4.0
    return ml.color_blend(color, torch.zeros(3, dtype=torch.uint8, device=color.device), t)


def shade_glow(frag, uniforms, textures, config):
    """Texture modulated by the interpolated user attribute "attr:glow"."""
    color = sample_frag(textures, frag, ("texture",))["texture"]
    t = frag["attr:glow"][..., 0].clamp(0.0, 1.0)
    return ml.color_blend(color, torch.zeros(3, dtype=torch.uint8, device=color.device), t)


def register():
    """Register "toon" and "glow" (replacing earlier registrations)."""
    from ..pipelines.frame import register_pipeline

    register_pipeline("toon", shade_toon, varying_spec=TOON_SPEC, maps=("texture",),
                      needs=("vertex_intensity",), overwrite=True)
    register_pipeline("glow", shade_glow, varying_spec=GLOW_SPEC, maps=("texture",),
                      overwrite=True)


def glow_attribute(model):
    """Per-corner "glow" from the model's height: (T, 3, 1) float32 (any
    (T, 3, k) float values work: skinning weights, AO bakes, paint)."""
    corners = np.asarray(model.mesh.positions)[np.asarray(model.mesh.pos_idx)]
    return np.clip(0.5 + corners[..., 1], 0.0, 1.0)[..., None].astype(np.float32)


def main(argv=None):
    from .. import RenderConfig, Scene, load_model
    from ..app import flagship_model
    from ..utils.png import write_png

    ap = argparse.ArgumentParser(description="render the toon and glow custom pipelines")
    ap.add_argument("asset_dir", nargs="?", help="asset directory (default: procedural stand-in)")
    ap.add_argument("out", nargs="?", default="toon.png", help="output PNG (default toon.png)")
    ap.add_argument("--size", nargs=2, type=int, default=[800, 800], metavar=("W", "H"))
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    register()
    model = load_model(args.asset_dir) if args.asset_dir else flagship_model()
    config = RenderConfig(width=args.size[0], height=args.size[1])
    scene = Scene(model, "toon", config, device=args.backend)
    scene.set_light_direction([0.35, 0.0, 0.94])
    frame = scene.get_frame_buffer()
    write_png(args.out, frame)
    print(f"wrote {args.out} ({frame.shape[1]}x{frame.shape[0]})")

    gscene = Scene(model, "glow", config, device=args.backend,
                   vertex_attrs={"glow": glow_attribute(model)})
    gout = args.out.rsplit(".", 1)[0] + "-glow.png"
    write_png(gout, gscene.get_frame_buffer())
    print(f"wrote {gout}")


if __name__ == "__main__":
    main()
