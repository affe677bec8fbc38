"""State estimation: the time-delay Kalman filter, the pose EKF and the
host-side measurement plumbing."""
