"""Plain reference of the upstream renderer's occlusion pipeline (two passes, ambient occlusion).

Written from the upstream semantics (litzendraht/tiny_renderer: src/scene.rs,
src/scene/shader.rs:806-963, src/scene/util.rs), independent of the program
under test: it imports torch and numpy only.  Every float is computed in
`dtype` (float32 as the upstream computes; the control computes in
bfloat16), one operation at a time in the upstream's accumulation order.

* The matrix stack, the coverage, the barycentrics and the depth resolve
  are shadow.py's (the same upstream code), repeated here because a
  reference imports nothing but torch and numpy.
* Pass 1 (shader.rs:809-847): the camera at the light direction, no
  culling, every covered fragment keeps the larger depth.
* Pass 2 (shader.rs:849-963): back faces culled, strictly greater depth
  wins (the first triangle keeps a tie).  Each covered pixel (x, y) with
  its interpolated depth z is taken back to the world through ``i_vpmv``
  and into the light's screen through ``shadow_matrix * i_vpmv``; the light
  direction comes back to the world through ``i_m`` (the inverse model
  matrix) from the camera frame's ``normalize(m * light)``.  The rotation
  taking +z to that direction is nalgebra's ``Rotation3::rotation_between``
  (normalize both, axis = the normalized cross product unless its norm is
  at most f32::EPSILON, angle = acos of the dot, ``from_axis_angle``'s
  matrix).  Sample i of 16 lies at ``world + R * (sin a_i, 0, cos a_i) *
  0.02`` with ``a_i = (2 pi / 16) * i`` in float32, projected through
  ``shadow_matrix``.  The light's depth buffer is read at the 16 samples
  and at the fragment's own shadow coordinate (f); a sample s with
  ``s - 1.0 > f`` takes ``(1/16) * min((s - f) / 20, 1)`` off the
  coefficient, which starts at 1.  The pixel is ``white * coefficient``.
* The frame is presented flipped vertically (scene.rs:92-97).

Departures from the upstream, each where the upstream panics or gives NaN:

* Triangles with an on-screen corner beyond +-2^14 are dropped and reported
  as overflow (where the edge functions stop being exact in 32 bits).
* A depth-buffer index out of range is clamped into it (the upstream panics).
* For exactly opposite vectors nalgebra returns None and the upstream
  panics (shader.rs:921 unwrap); here the rotation is 180 degrees about x.
* The dot is clamped into [-1, 1] before acos, where a rounding past 1
  would give NaN; elsewhere the angle is the same.

The raster is not serial: every fragment of every triangle's bounding box is
formed at once, and the depth test is resolved per pixel by a maximum (and,
among equal depths, the lowest triangle index), which is what the serial
loop leaves behind.
"""

from __future__ import annotations

import numpy as np
import torch

F32_MIN = float(np.finfo(np.float32).min)
F32_EPSILON = float(np.finfo(np.float32).eps)
EXACT_COORD_MAX = 1 << 14
_I32 = (-2.0 ** 31, 2.0 ** 31 - 1)
_U32_MAX = 2.0 ** 32 - 1


def _cast_int(x, lo, hi):
    """Rust `as` from a float: NaN to 0, saturate, truncate toward zero (int64)."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=hi, neginf=lo).clamp(lo, hi)
    return torch.trunc(x).to(torch.int64)


def _round_half_away(x):
    """f32::round: halves away from zero (in float64, exact for these values)."""
    x = x.double()
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


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
    """Cofactor-expansion inverse of a (4, 4) matrix (nalgebra's try_inverse)."""
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


def rotation_between(a, b):
    """nalgebra's Rotation3::rotation_between(a, b) of two 3-vectors, as a
    (3, 3) matrix: the identity when they are aligned, 180 degrees about x
    when exactly opposite (where nalgebra gives None)."""
    na_, nb_ = _normalize(a), _normalize(b)
    c = _cross(na_, nb_)
    n = _norm(c)
    d = _dot(na_, nb_)
    if float(n) <= F32_EPSILON:
        sign = 1.0 if float(d) >= 0.0 else -1.0
        return torch.diag(torch.tensor([1.0, sign, sign], dtype=a.dtype, device=a.device))
    ux, uy, uz = (c / n).unbind(-1)
    angle = torch.arccos(d.clamp(-1.0, 1.0))
    sin, cos = torch.sin(angle), torch.cos(angle)
    sqx, sqy, sqz = ux * ux, uy * uy, uz * uz
    one_m_cos = 1.0 - cos
    return torch.stack([
        torch.stack([sqx + (1.0 - sqx) * cos, ux * uy * one_m_cos - uz * sin, ux * uz * one_m_cos + uy * sin]),
        torch.stack([ux * uy * one_m_cos + uz * sin, sqy + (1.0 - sqy) * cos, uy * uz * one_m_cos - ux * sin]),
        torch.stack([ux * uz * one_m_cos - uy * sin, uy * uz * one_m_cos + ux * sin, sqz + (1.0 - sqz) * cos])])


def occlusion_update(svals, fval, threshold, depth_scale):
    """shader.rs:929-941: svals (..., n) depth-buffer values at the n
    samples, fval (...) the value at the fragment's own shadow coordinate;
    the coefficient, 1 less (1/n) * min((s - f) / depth_scale, 1) for each
    sample s with s - threshold > f, in sample order."""
    n = svals.shape[-1]
    inv_n = 1.0 / torch.tensor(float(n), dtype=svals.dtype, device=svals.device)
    occ = torch.ones_like(fval)
    for i in range(n):
        s = svals[..., i]
        strength = torch.clamp((s - fval) / depth_scale, max=1.0)
        occ = torch.where(s - threshold > fval, occ - inv_n * strength, occ)
    return occ


class OcclusionReference:
    """The occlusion pipeline's frames of one mesh at width x height.

    mesh: numpy arrays (positions, pos_idx, ...).  Computes on `device` in
    `dtype`; the matrix stack runs on the CPU in the same dtype."""

    def __init__(self, mesh, width, height, *, depth=255.0, projection_coef=-0.2, occlusion_samples=16,
                 occlusion_step=0.02, occlusion_threshold=1.0, occlusion_depth_scale=20.0,
                 dtype=torch.float32, device="cpu"):
        self.device, self.dtype = torch.device(device), dtype
        self.W, self.H = int(width), int(height)
        dev = self.device
        v = torch.from_numpy(np.asarray(mesh["positions"], np.float32))
        self.pos = v[torch.from_numpy(np.asarray(mesh["pos_idx"], np.int64))].to(dev, dtype)  # (T, 3, 3)
        c = lambda x: torch.tensor(x, dtype=torch.float32).to(dtype)  # noqa: E731
        self.coef = c(projection_coef)
        self.step, self.threshold, self.scale = c(occlusion_step), c(occlusion_threshold), c(occlusion_depth_scale)
        # The sample directions (sin a_i, 0, cos a_i), a_i = (2 pi / n) * i.
        angle_coef = c(2.0 * np.pi) / c(float(occlusion_samples))
        a = torch.stack([angle_coef * c(float(i)) for i in range(occlusion_samples)])
        self.dirs = torch.stack([torch.sin(a), torch.zeros_like(a), torch.cos(a)], dim=-1).to(dev)  # (n, 3)
        w, h, d, two = c(self.W - 1), c(self.H - 1), c(depth), c(2.0)
        zero, one = c(0.0), c(1.0)
        self.viewport = torch.stack([
            torch.stack([w / two, zero, zero, w / two]),
            torch.stack([zero, h / two, zero, h / two]),
            torch.stack([zero, zero, d / two, d / two]),
            torch.stack([zero, zero, zero, one])])

    # -- the matrix stack (CPU) ---------------------------------------------

    def _prepare(self, light, look_from, look_at, up):
        """default_prepare: vpmv, the model matrix and the light in the camera's frame."""
        dt = self.dtype
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
        return {"vpmv": vpmv, "m": model, "camera_direction": new_z,
                "light": _normalize(_vector(model, light))}

    def uniforms(self, light, look_from, look_at, up):
        """The two passes' uniforms and the probe's rotation, on the device."""
        args = [torch.as_tensor(v).detach().cpu().to(torch.float32).to(self.dtype)
                for v in (light, look_from, look_at, up)]
        light, look_from, look_at, up = args
        shadow_matrix = self._prepare(light, light, look_at, up)["vpmv"]
        cam = self._prepare(light, look_from, look_at, up)
        cam["i_vpmv"] = _inverse4(cam["vpmv"])
        cam["shadow_matrix"] = shadow_matrix
        world_light = _vector(_inverse4(cam["m"]), cam["light"])
        cam["rotation"] = rotation_between(torch.tensor([0.0, 0.0, 1.0], dtype=self.dtype), world_light)
        return {k: v.to(self.device) for k, v in cam.items()}

    # -- triangles and fragments (device) -------------------------------------

    def _setup(self, matrix, cull_direction=None):
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
        keep = s["cz"] != 0
        if cull_direction is not None:
            p = self.pos
            face = _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            keep &= _dot(cull_direction, face) > 0
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

    def _depth(self, pix, z):
        buf = torch.full((self.H * self.W,), F32_MIN, dtype=torch.float32, device=self.device)
        return buf.scatter_reduce(0, pix, z, "amax", include_self=True)

    def _read(self, buffer, sc):
        """buffer[round(x) as u32 + round(y) as u32 * width] at shadow
        coordinates sc (..., 3), the index wrapped to u32 and clamped."""
        ix = _cast_int(_round_half_away(sc[..., 0]), 0.0, _U32_MAX)
        iy = _cast_int(_round_half_away(sc[..., 1]), 0.0, _U32_MAX)
        flat = ((ix + iy * self.W) & 0xFFFFFFFF).clamp(max=self.H * self.W - 1)
        return buffer[flat].to(self.dtype)

    # -- the frame ----------------------------------------------------------

    def frame(self, light, look_from, look_at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
        """(H, W, 3) u8 numpy frame as presented, and the overflow flag."""
        u = self.uniforms(light, look_from, look_at, up)
        dt, H, W = self.dtype, self.H, self.W

        s1, ovf1 = self._setup(u["shadow_matrix"])
        pix1, _, z1 = self._fragments(s1)
        shadow = self._depth(pix1, z1)

        s, ovf2 = self._setup(u["vpmv"], cull_direction=u["camera_direction"])
        pix, t, z = self._fragments(s)
        best = self._depth(pix, z)
        top = z == best[pix]
        big = torch.iinfo(torch.int64).max
        idx = torch.full((H * W,), big, dtype=torch.int64, device=self.device)
        idx = idx.scatter_reduce(0, pix[top], t[top], "amin", include_self=True)
        covered = torch.nonzero(idx != big).flatten()
        t = idx[covered]
        px, py = covered % W, covered // W

        (b0, b1, b2), _ = self._bary(s, t, px, py)
        zv = s["zv"][t]
        zfrag = (zv[:, 0] * b0 + zv[:, 1] * b1) + zv[:, 2] * b2
        p = torch.stack([px.to(dt), py.to(dt), zfrag], dim=-1)            # (N, 3)
        world = _point(u["i_vpmv"], p)
        fval = self._read(shadow, _point(_matmul4(u["shadow_matrix"], u["i_vpmv"]), p))
        r = u["rotation"]
        rotated = torch.stack([(r[i, 0] * self.dirs[:, 0] + r[i, 1] * self.dirs[:, 1]) + r[i, 2] * self.dirs[:, 2]
                               for i in range(3)], dim=-1)                # (n, 3)
        samples = world[:, None, :] + (rotated * self.step.to(self.device))[None]
        svals = self._read(shadow, _point(u["shadow_matrix"], samples))   # (N, n)
        occ = occlusion_update(svals, fval, self.threshold.to(self.device), self.scale.to(self.device))
        grey = _cast_int(occ * 255.0 + (1.0 - occ) * 0.0, 0.0, 255.0).to(torch.uint8)

        out = torch.zeros((H * W, 3), dtype=torch.uint8, device=self.device)
        out[covered] = grey[:, None].expand(-1, 3)
        return out.reshape(H, W, 3).flip(0).cpu().numpy(), ovf1 or ovf2


def make(config, mesh, maps, device, dtype=torch.float32):
    """The reference of a configuration file's frame (its width, height and
    render constants), for its mesh; the occlusion pipeline reads no map.
    TF32 is switched off, so that no float32 product runs in it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rc = config.get("render_config", {})
    keys = ("depth", "projection_coef", "occlusion_samples", "occlusion_step", "occlusion_threshold",
            "occlusion_depth_scale")
    return OcclusionReference(mesh, config["width"], config["height"], dtype=dtype, device=device,
                              **{k: rc[k] for k in keys if k in rc})
