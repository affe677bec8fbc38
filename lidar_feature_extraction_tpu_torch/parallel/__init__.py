"""Keyframe graph back-ends: the pose graph and the IMU-aware graph
(single device)."""
