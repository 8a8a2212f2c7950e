"""The ``burst`` loop: back-to-back ``Scene.render_sequence(cams, ligs)``
calls of ``frames_per_call`` frames (as ``app.run_sequence`` renders an
animation), every frame returned to the host.  Measures ``burst_fps``:
the frames returned over all the window's time."""

import time

import numpy as np

from benchmark.orbit import Loop as _Base
from benchmark.orbit import device_vectors


class Loop(_Base):
    def call(self):
        """One render_sequence call: (frames as returned, its pose angles)."""
        k = self.traffic["frames_per_call"]
        cams, ligs = self.orbit.angles(self.n, k)
        self.n += k
        return self.scene.render_sequence(cams, ligs), cams, ligs

    def step(self):
        self.call()

    def window(self, seconds, sample):
        frames = 0
        t0 = time.perf_counter()
        while True:
            out, cams, ligs = self.call()
            frames += len(out)
            for i in range(len(out)):
                sample.offer(lambda i=i: (np.ascontiguousarray(out[i]), (float(cams[i]), float(ligs[i]))))
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        return frames, {"burst_fps": frames / (t - t0)}

    def traced(self):
        """traced_calls calls; returns the frames rendered.  No host spans of
        its own: its per-layer metrics read the trace and the stage breakdown."""
        for _ in range(self.traffic["traced_calls"]):
            self.call()
        return self.traffic["traced_calls"] * self.traffic["frames_per_call"]


def reference_pose(device):
    """A burst's vectors: sin and cos of its float32 angles on the device."""
    return lambda angles: device_vectors(*angles, device)
