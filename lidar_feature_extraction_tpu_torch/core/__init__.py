"""Scan container, pose, quaternion calculus and robust statistics."""
