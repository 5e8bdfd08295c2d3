"""Synthetic VI dataset simulator.

Generates full-scale EuRoC-format (ASL folder) visual-inertial datasets: a
textured-room renderer with the real radtan distortion model, analytic smooth
trajectories with exact 200 Hz IMU, and ground truth in the EuRoC
state_groundtruth CSV format. This is the validation stand-in while the real
dataset is unreachable (zero-egress container): the generated sequences run
through examples/run_euroc.py byte-identically to a real EuRoC download
(same loaders, same undistortion, same profile).
"""
from mc_slam.sim.room import RoomWorld
from mc_slam.sim.trajectory import MavTrajectory
