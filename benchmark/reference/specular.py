"""Plain reference of the upstream renderer's specular pipeline (one pass, normal map + Phong specular).

Written from the upstream semantics (litzendraht/tiny_renderer: src/scene.rs,
src/scene/shader.rs:472-543, src/scene/util.rs), independent of the program
under test: it imports torch and numpy only.  Every float is computed in
`dtype` (float32 as the upstream computes; the control computes in
bfloat16), one operation at a time in the upstream's accumulation order.

* The matrix stack of ``default_prepare`` (shader.rs:183-230): the camera
  basis, view, projection (w' = 1 + coef * z) and viewport, products in
  nalgebra's order; ``it_m`` the inverse of the transposed model matrix;
  the light rotated by the model matrix and normalized.  Repeated from
  darboux.py (the same upstream code), because a reference imports nothing
  but torch and numpy.
* Coverage, barycentrics and the depth resolve as darboux.py's: back faces
  culled (``camera_direction . face normal > 0`` keeps a face), strictly
  greater depth wins (the first triangle keeps a tie).
* The vertex shader (shader.rs:472-497): each triangle's uvs with v
  flipped (``1 - v``, shader.rs:136-147), interpolated at the winner as
  ``(uv0 b0 + uv1 b1) + uv2 b2``.
* The fragment shader (shader.rs:498-534), at each covered pixel's winner
  (``specular_shade``): the object-space normal of the normal map through
  ``it_m`` (a vector: w = 0) and normalized, ``t_n``; the diffuse term
  ``d = light . t_n``; the reflection ``r = normalize(t_n (2 d) - light)``
  (:515-518); since the camera looks down -z in its own frame, only
  ``r.z`` matters (:520-525): ``spec = 0.6 max(r.z, 0)^e`` with ``e`` the
  specular map's raw byte; each channel ``(d + spec) c`` of the texel
  ``c``, clamped at 255 and cast ``as u8`` (NaN to 0, saturating;
  :526-530).
* Sampling (util.rs:34-83): nearest texel ``(uv * dims) as u32`` of each
  map in its own dimensions; the normal decoded ``byte / 255 - 0.5`` per
  channel and normalized (util.rs:51-56); the specular map's first byte,
  0 to 255, used raw as the exponent (util.rs:76-83).
* The frame is presented flipped vertically (scene.rs:92-97).

Departures from the upstream:

* Triangles with an on-screen corner beyond +-2^14 are dropped and reported
  as overflow (where the edge functions stop being exact in 32 bits).
* A texel index out of range is clamped into the map (util.rs:35-40 would
  index past it and panic).
* ``max(r.z, 0)^e`` is torch's ``pow`` in the working precision (on the
  card the device's float32 library, on the CPU the host's), in place of
  Rust's ``powf``; the two may differ in the last bits.
* The clamp at 255 keeps a NaN (which ``as u8`` then makes 0), where
  Rust's ``f32::min`` returns 255 for a NaN operand.  No NaN arises from
  these maps: a decoded normal is never zero (no byte is 127.5) and the
  reflection of a unit light about a unit normal is a unit vector.
* The upstream's specular map is an 8-bpp grayscale image; here it is any
  (h, w, 3) u8 map whose first channel is read.

Assumed, since nalgebra 0.31's source cannot be read here: its 4x4 inverse
(``it_m``) is taken as darboux.py's cofactor expansion, which can differ
from nalgebra's in the last bit only; a vector is normalized by dividing by
its norm.

The raster is not serial: every fragment of every triangle's bounding box is
formed at once, and the depth test is resolved per pixel by a maximum (and,
among equal depths, the lowest triangle index), which is what the serial
loop leaves behind.
"""

from __future__ import annotations

import numpy as np
import torch

F32_MIN = float(np.finfo(np.float32).min)
EXACT_COORD_MAX = 1 << 14
_I32 = (-2.0 ** 31, 2.0 ** 31 - 1)
_U32_MAX = 2.0 ** 32 - 1


def _cast_int(x, lo, hi):
    """Rust `as` from a float: NaN to 0, saturate, truncate toward zero (int64)."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=hi, neginf=lo).clamp(lo, hi)
    return torch.trunc(x).to(torch.int64)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _norm(a):
    # The square root correctly rounded into the working precision.
    return torch.sqrt(_dot(a, a).double()).to(a.dtype)


def _normalize(a):
    return a / _norm(a)[..., None]


def _matmul4(a, b):
    """(4, 4) product, each entry (a0 b0 + a1 b1) + (a2 b2 + a3 b3)."""
    return torch.stack([torch.stack([
        (a[i, 0] * b[0, j] + a[i, 1] * b[1, j]) + (a[i, 2] * b[2, j] + a[i, 3] * b[3, j])
        for j in range(4)]) for i in range(4)])


def _inverse4(m):
    """Cofactor-expansion inverse of a (4, 4) matrix (shadow.py's)."""
    e = [[m[i, j] for j in range(4)] for i in range(4)]
    (a0, a1, a2, a3), (b0, b1, b2, b3), (c0_, c1_, c2_, c3_), (d0, d1, d2, d3) = e
    s0, s1, s2 = a0 * b1 - b0 * a1, a0 * b2 - b0 * a2, a0 * b3 - b0 * a3
    s3, s4, s5 = a1 * b2 - b1 * a2, a1 * b3 - b1 * a3, a2 * b3 - b2 * a3
    k5, k4, k3 = c2_ * d3 - d2 * c3_, c1_ * d3 - d1 * c3_, c1_ * d2 - d1 * c2_
    k2, k1, k0 = c0_ * d3 - d0 * c3_, c0_ * d2 - d0 * c2_, c0_ * d1 - d0 * c1_
    det = s0 * k5 - s1 * k4 + s2 * k3 + s3 * k2 - s4 * k1 + s5 * k0
    inv = 1.0 / det
    rows = [
        [(b1 * k5 - b2 * k4 + b3 * k3) * inv, (-a1 * k5 + a2 * k4 - a3 * k3) * inv,
         (d1 * s5 - d2 * s4 + d3 * s3) * inv, (-c1_ * s5 + c2_ * s4 - c3_ * s3) * inv],
        [(-b0 * k5 + b2 * k2 - b3 * k1) * inv, (a0 * k5 - a2 * k2 + a3 * k1) * inv,
         (-d0 * s5 + d2 * s2 - d3 * s1) * inv, (c0_ * s5 - c2_ * s2 + c3_ * s1) * inv],
        [(b0 * k4 - b1 * k2 + b3 * k0) * inv, (-a0 * k4 + a1 * k2 - a3 * k0) * inv,
         (d0 * s4 - d1 * s2 + d3 * s0) * inv, (-c0_ * s4 + c1_ * s2 - c3_ * s0) * inv],
        [(-b0 * k3 + b1 * k1 - b2 * k0) * inv, (a0 * k3 - a1 * k1 + a2 * k0) * inv,
         (-d0 * s3 + d1 * s1 - d2 * s0) * inv, (c0_ * s3 - c1_ * s1 + c2_ * s0) * inv],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def _point(m, p):
    """Point3 through a (4, 4) matrix: w = 1 in, divided by w' out."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    o = [((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] for i in range(4)]
    return torch.stack([o[0] / o[3], o[1] / o[3], o[2] / o[3]], dim=-1)


def _vector(m, v):
    """Vector3 through a (4, 4) matrix: w = 0, no divide."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([(m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z for i in range(3)], dim=-1)


def specular_shade(color, normal, exponent, it_m, light, scale):
    """shader.rs:498-530 for (N, 3) texels `color` (in the working dtype),
    decoded object-space normals `normal`, exponents `exponent` (N,), the
    (4, 4) ``it_m``, the light in the camera's frame and the specular
    scale (a 0-d tensor): the (N, 3) u8 colours."""
    t_n = _normalize(_vector(it_m, normal))
    d = _dot(light, t_n)
    r = _normalize(t_n * (d * 2.0)[..., None] - light)
    spec = scale * torch.pow(torch.clamp(r[..., 2], min=0.0), exponent)
    lit = torch.clamp((d + spec)[..., None] * color, max=255.0)
    return _cast_int(lit, 0.0, 255.0).to(torch.uint8)


class SpecularReference:
    """The specular pipeline's frames of one mesh and its maps at width x height.

    mesh: numpy arrays (positions, tex_coords, normals, pos_idx, tex_idx,
    normal_idx); maps: (h, w, 3) u8 tensors "texture", "normal_map" and
    "specular_map" (its first channel the exponent).  Computes on `device`
    in `dtype`; the matrix stack runs on the CPU in the same dtype."""

    def __init__(self, mesh, maps, width, height, *, depth=255.0, projection_coef=-0.2,
                 specular_scale=0.6, dtype=torch.float32, device="cpu"):
        self.device, self.dtype = torch.device(device), dtype
        self.W, self.H = int(width), int(height)
        dev = self.device

        def tri(values, idx):
            v = torch.from_numpy(np.asarray(values, np.float32))
            i = torch.from_numpy(np.asarray(idx, np.int64))
            return v[i].to(dev, dtype)

        self.pos = tri(mesh["positions"], mesh["pos_idx"])        # (T, 3, 3)
        uv = tri(mesh["tex_coords"], mesh["tex_idx"])             # (T, 3, 2)
        self.uv = torch.stack([uv[..., 0], 1.0 - uv[..., 1]], dim=-1)
        self.texture = maps["texture"].to(dev)
        self.normal_map = maps["normal_map"].to(dev)
        self.specular_map = maps["specular_map"].to(dev)
        c = lambda v: torch.tensor(v, dtype=torch.float32).to(dtype)  # noqa: E731
        self.coef = c(projection_coef)
        self.scale = c(specular_scale).to(dev)
        self.byte, self.half = c(255.0).to(dev), c(0.5).to(dev)
        w, h, d, two = c(self.W - 1), c(self.H - 1), c(depth), c(2.0)
        zero, one = c(0.0), c(1.0)
        self.viewport = torch.stack([
            torch.stack([w / two, zero, zero, w / two]),
            torch.stack([zero, h / two, zero, h / two]),
            torch.stack([zero, zero, d / two, d / two]),
            torch.stack([zero, zero, zero, one])])

    # -- the matrix stack (CPU) ---------------------------------------------

    def uniforms(self, light, look_from, look_at, up):
        """default_prepare: vpmv, the model matrix, it_m, the camera
        direction and the light in the camera's frame, on the device."""
        dt = self.dtype
        light, look_from, look_at, up = [torch.as_tensor(v).detach().cpu().to(torch.float32).to(dt)
                                         for v in (light, look_from, look_at, up)]
        new_z = _normalize(look_from - look_at)
        new_y = _normalize(up - _dot(new_z, up) * new_z)
        new_x = _normalize(_cross(new_y, new_z))
        zero, one = torch.zeros((), dtype=dt), torch.ones((), dtype=dt)
        model = torch.stack([torch.stack([*new_x, zero]), torch.stack([*new_y, zero]),
                             torch.stack([*new_z, zero]), torch.stack([zero, zero, zero, one])])
        view = torch.stack([torch.stack([one, zero, zero, -look_from[0]]),
                            torch.stack([zero, one, zero, -look_from[1]]),
                            torch.stack([zero, zero, one, -look_from[2]]),
                            torch.stack([zero, zero, zero, one])])
        projection = torch.eye(4, dtype=dt)
        projection[3, 2] = self.coef
        vpmv = _matmul4(_matmul4(_matmul4(self.viewport, projection), model), view)
        u = {"vpmv": vpmv, "m": model, "it_m": _inverse4(model.T.contiguous()),
             "camera_direction": new_z, "light": _normalize(_vector(model, light))}
        return {k: v.to(self.device) for k, v in u.items()}

    # -- triangles and fragments (device) -------------------------------------

    def _setup(self, matrix, cull_direction):
        """Integer screen corners, edge functions and bounding boxes; the
        triangles kept, and whether an on-screen one left the exact range."""
        tp = _point(matrix, self.pos)
        rx = _cast_int(tp[..., 0], *_I32)
        ry = _cast_int(tp[..., 1], *_I32)
        x1, x2, x3 = rx.unbind(1)
        y1, y2, y3 = ry.unbind(1)
        s = {"zv": tp[..., 2],
             "a1": y3 - y1, "b1": x1 - x3, "c1": x3 * y1 - x1 * y3,
             "a2": y1 - y2, "b2": x2 - x1, "c2": x1 * y2 - x2 * y1,
             "cz": (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)}
        p = self.pos
        face = _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        keep = (s["cz"] != 0) & (_dot(cull_direction, face) > 0)
        s["x0"] = rx.min(1).values.clamp(min=0)
        s["x1"] = rx.max(1).values.clamp(max=self.W - 1)
        s["y0"] = ry.min(1).values.clamp(min=0)
        s["y1"] = ry.max(1).values.clamp(max=self.H - 1)
        keep &= (s["x0"] <= s["x1"]) & (s["y0"] <= s["y1"])
        exact = ((rx.abs() <= EXACT_COORD_MAX) & (ry.abs() <= EXACT_COORD_MAX)).all(1)
        overflow = bool((keep & ~exact).any())
        s["keep"] = keep & exact
        return s, overflow

    def _bary(self, s, t, px, py):
        """Barycentrics (w, u, v) of pixels (px, py) in triangles t, from the
        exact integer edge functions, and whether the pixel is inside."""
        cx = s["a1"][t] * px + s["b1"][t] * py + s["c1"][t]
        cy = s["a2"][t] * px + s["b2"][t] * py + s["c2"][t]
        cz = s["cz"][t]
        pos = cz > 0
        inside = torch.where(pos, (cx >= 0) & (cy >= 0) & (cz - cx - cy >= 0),
                             (cx <= 0) & (cy <= 0) & (cz - cx - cy <= 0))
        cxf, cyf, czf = cx.to(self.dtype), cy.to(self.dtype), cz.to(self.dtype)
        return (1.0 - (cxf + cyf) / czf, cxf / czf, cyf / czf), inside

    def _fragments(self, s):
        """Every covered (pixel, triangle) pair of the kept triangles: flat
        pixel index, triangle index, depth."""
        t_all = torch.nonzero(s["keep"]).flatten()
        bw = s["x1"][t_all] - s["x0"][t_all] + 1
        n = bw * (s["y1"][t_all] - s["y0"][t_all] + 1)
        which = torch.repeat_interleave(torch.arange(t_all.numel(), device=self.device), n)
        first = torch.cumsum(n, 0) - n
        off = torch.arange(which.numel(), device=self.device) - first[which]
        t = t_all[which]
        px = s["x0"][t] + off % bw[which]
        py = s["y0"][t] + off // bw[which]
        (w, u, v), inside = self._bary(s, t, px, py)
        zv = s["zv"][t]
        z = (w * zv[:, 0] + u * zv[:, 1]) + v * zv[:, 2]
        keep = inside & (z > F32_MIN)
        return (py * self.W + px)[keep], t[keep], z[keep].to(torch.float32)

    def _sample(self, tex, uv):
        """The (N, c) texels of map `tex` at (uv * dims) as u32, the index
        clamped into the map, in the working dtype."""
        h, w = tex.shape[:2]
        dt = self.dtype
        cx = _cast_int(uv[:, 0] * torch.tensor(float(w), dtype=dt), 0.0, _U32_MAX).clamp(max=w - 1)
        cy = _cast_int(uv[:, 1] * torch.tensor(float(h), dtype=dt), 0.0, _U32_MAX).clamp(max=h - 1)
        return tex[cy, cx].to(dt)

    # -- the frame ----------------------------------------------------------

    def frame(self, light, look_from, look_at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
        """(H, W, 3) u8 numpy frame as presented, and the overflow flag."""
        u = self.uniforms(light, look_from, look_at, up)
        H, W = self.H, self.W

        s, overflow = self._setup(u["vpmv"], u["camera_direction"])
        pix, t, z = self._fragments(s)
        best = torch.full((H * W,), F32_MIN, dtype=torch.float32, device=self.device)
        best = best.scatter_reduce(0, pix, z, "amax", include_self=True)
        top = z == best[pix]
        big = torch.iinfo(torch.int64).max
        idx = torch.full((H * W,), big, dtype=torch.int64, device=self.device)
        idx = idx.scatter_reduce(0, pix[top], t[top], "amin", include_self=True)
        covered = torch.nonzero(idx != big).flatten()
        t = idx[covered]
        px, py = covered % W, covered // W
        (b0, b1, b2), _ = self._bary(s, t, px, py)
        uv = self.uv[t]
        uv = (uv[:, 0] * b0[:, None] + uv[:, 1] * b1[:, None]) + uv[:, 2] * b2[:, None]   # (N, 2)

        color = self._sample(self.texture, uv)                                            # (N, 3)
        normal = _normalize(self._sample(self.normal_map, uv) / self.byte - self.half)
        exponent = self._sample(self.specular_map, uv)[:, 0]
        rgb = specular_shade(color, normal, exponent, u["it_m"], u["light"], self.scale)

        out = torch.zeros((H * W, 3), dtype=torch.uint8, device=self.device)
        out[covered] = rgb
        return out.reshape(H, W, 3).flip(0).cpu().numpy(), overflow


def make(config, mesh, maps, device, dtype=torch.float32):
    """The reference of a configuration file's frame (its width, height and
    render constants), for its mesh and maps.  TF32 is switched off, so that
    no float32 product runs in it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rc = config.get("render_config", {})
    return SpecularReference(mesh, maps, config["width"], config["height"], dtype=dtype, device=device,
                             **{k: rc[k] for k in ("depth", "projection_coef", "specular_scale") if k in rc})
