"""What every traffic loop shares: the orbit, the pose vectors, the sample of
returned frames, and the loop's base class.

A traffic mix (``traffic/<mix>.json``) names its ``loop``; the harness loads
``loops/<loop>.py``, which holds that loop and nothing else.  Every loop
follows an orbit (src/app.rs:200-207): the camera and the light on the unit
circle of the XZ plane, stepping ``camera_step_rad`` and ``light_step_rad``
a frame from start angles drawn from the seed, so no two frames of a run
repeat.  Each loop keeps a sample of the frames it returned in the window
(drawn from the seed, a reservoir) with the pose each was rendered at, for
the comparison with the reference.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    from `seed`; make() is called only for an item that is kept."""

    def __init__(self, k, seed):
        self.k, self.items, self.seen = k, [], 0
        self._rng = random.Random(seed)

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


class Orbit:
    """Camera and light angles of frame n (float32, wrapped into [0, 2 pi))."""

    def __init__(self, seed, camera_step, light_step):
        rng = np.random.default_rng(seed)
        self.c0, self.l0 = rng.uniform(0.0, TWO_PI, size=2)
        self.dc, self.dl = camera_step, light_step

    def angles(self, first, count):
        n = np.arange(first, first + count, dtype=np.float64)
        cams = np.mod(self.c0 + self.dc * n, TWO_PI).astype(np.float32)
        ligs = np.mod(self.l0 + self.dl * n, TWO_PI).astype(np.float32)
        return cams, ligs


def host_vectors(camera_angle, light_angle):
    """(light, look_from) as the app's window loop sets them (app._angles_to_vectors)."""
    look_from = np.array([math.sin(camera_angle), 0.0, math.cos(camera_angle)], np.float32)
    light = np.array([math.sin(light_angle), 0.0, math.cos(light_angle)], np.float32)
    return light, look_from


def device_vectors(camera_angle, light_angle, device):
    """(light, look_from) as a burst makes them: sin and cos of the float32
    angles on the render device."""
    a = torch.tensor([camera_angle, light_angle], dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    look_from = torch.stack([torch.sin(a[0]), zero, torch.cos(a[0])])
    light = torch.stack([torch.sin(a[1]), zero, torch.cos(a[1])])
    return light.cpu().numpy(), look_from.cpu().numpy()


class Loop:
    """A closed loop over one Scene.  `n` counts the frames rendered so far,
    so every call continues the orbit.  A loop module's Loop defines:

    * step(): one iteration (set-up warms the loop with ``warmup_steps`` of
      them, then runs it for ``warmup_seconds``);
    * window(seconds, sample) -> (attempted, {end-to-end metric: value}):
      the measured window, offering each returned frame to `sample` as
      (frame, pose);
    * spans() -> {name: [seconds]}: the traced run's host spans;
    * traced() -> frames: the stretch the profiler traces.

    The module also defines reference_pose(device) -> pose(p) -> (light,
    look_from): the vectors a sampled frame was rendered at, made as the
    loop's program path makes them."""

    def __init__(self, scene, traffic, seed):
        self.scene, self.traffic = scene, traffic
        self.orbit = Orbit(seed, traffic["camera_step_rad"], traffic["light_step_rad"])
        self.n = 0

    def sync(self):
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)

    def spans(self):
        return {}
