"""Host-side helpers: synthetic scenes, the drive simulator and
trajectory evaluation."""
