"""Keyframe graph back-ends (the pose graph and the IMU-aware graph) and
the batched localizer, on a single device."""
