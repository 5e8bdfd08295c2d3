"""Live streaming driver surface: frame callback + back-pressure.

The reference's live path is a ROS node that subscribes to image/IMU topics
and back-pressures the bag iterator on LocalMapping's queue
(Examples/ROS/VIO/src/ros_vio.cpp:156-166, bLocalMapAcceptKF). The
device pipeline has no threads to back-pressure — its in-flight unit is
the async dispatch pipeline — so the streaming contract becomes:

  * `on_frame(t, img, imu)` is the source callback (camera driver, socket,
    bag iterator). It NEVER blocks: when the pipeline is saturated the
    frame is dropped and its IMU rows are CARRIED into the next processed
    frame, keeping preintegration continuous across drops (dropping IMU
    would corrupt the keyframe chain the way a real sensor gap does).
  * `accepting()` mirrors bLocalMapAcceptKF for sources that can pause
    (rosbag-style iterators) instead of dropping.
"""
from __future__ import annotations

import numpy as np


class StreamDriver:
    """Wraps a SlamSystem for push-style frame delivery with back-pressure.

    budget: extra in-flight dispatch entries tolerated beyond the system's
    own LAG_MAX before frames are dropped (0 = drop as soon as the pipeline
    is nominally full)."""

    def __init__(self, slam, budget: int = 0):
        self.slam = slam
        self.budget = int(budget)
        self._imu_carry: list[np.ndarray] = []
        self.n_dropped = 0
        self.n_processed = 0

    def accepting(self) -> bool:
        """True when the pipeline can absorb a frame without blocking (the
        bLocalMapAcceptKF analog for pausable sources)."""
        return len(self.slam._pendings) < self.slam.LAG_MAX + self.budget

    def on_frame(self, t, img, imu=None) -> bool:
        """Deliver one frame from the live source. Returns True if the frame
        entered the pipeline, False if it was dropped (its IMU is kept)."""
        if imu is not None and len(imu):
            self._imu_carry.append(np.asarray(imu, np.float32))
        if not self.accepting():
            self.n_dropped += 1
            return False
        rows = (np.concatenate(self._imu_carry, 0)
                if self._imu_carry else None)
        self._imu_carry = []
        self.slam.track(self.slam.upload(img), t, imu=rows)
        self.n_processed += 1
        return True

    def finish(self):
        """Drain the pipeline at end of stream."""
        self.slam.flush()
