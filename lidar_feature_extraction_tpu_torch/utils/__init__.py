"""Host-side helpers: synthetic scenes, the drive simulator, trajectory
evaluation, checkpoints, stage timers and traces, PLY exports."""
