"""The ``frame`` loop: one frame at a time, ``set_camera`` /
``set_light_direction``, then ``Scene.render()``, then
``Scene.get_frame_buffer()`` (the window's frame under the reference's
serial presentation).  Measures ``frame_ms`` (the window over the frames
completed) and ``frame_ms_p95`` (the 95th percentile of every frame's
latency, from setting the camera to holding the frame on the host)."""

import statistics
import time

import numpy as np

from benchmark.orbit import Loop as _Base
from benchmark.orbit import host_vectors

ORIGIN = np.zeros(3, np.float32)
UP = np.array([0.0, 1.0, 0.0], np.float32)


class Loop(_Base):
    def set_pose(self):
        """Advance the orbit a frame and set the scene's camera and light:
        (light, look_from)."""
        cams, ligs = self.orbit.angles(self.n, 1)
        self.n += 1
        light, look_from = host_vectors(float(cams[0]), float(ligs[0]))
        self.scene.set_camera(look_from, ORIGIN, UP)
        self.scene.set_light_direction(light)
        return light, look_from

    def frame(self):
        """Set the pose, render, fetch: (frame, (light, look_from))."""
        pose = self.set_pose()
        self.scene.render()
        return self.scene.get_frame_buffer(), pose

    def step(self):
        self.frame()

    def window(self, seconds, sample):
        lat = []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            frame, pose = self.frame()
            t = time.perf_counter()
            lat.append(t - s)
            sample.offer(lambda: (frame, pose))  # a new array each frame: kept, not copied
            if t - t0 >= seconds:
                break
        p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 else lat[0]
        return len(lat), {"frame_ms": 1e3 * (t - t0) / len(lat), "frame_ms_p95": 1e3 * p95}

    def spans(self):
        """Per frame of span_frames: the host's issue (render's call to
        return) and, after an explicit synchronize, the fetch."""
        issue, blit = [], []
        for _ in range(self.traffic["span_frames"]):
            self.set_pose()
            t0 = time.perf_counter()
            self.scene.render()
            t1 = time.perf_counter()
            self.sync()
            t2 = time.perf_counter()
            self.scene.get_frame_buffer()
            t3 = time.perf_counter()
            issue.append(t1 - t0)
            blit.append(t3 - t2)
        return {"issue": issue, "blit": blit}

    def traced(self):
        for _ in range(self.traffic["traced_frames"]):
            self.frame()
        return self.traffic["traced_frames"]


def reference_pose(device):
    """A frame's vectors are the ones set on the host, kept with the frame."""
    return lambda vectors: vectors
