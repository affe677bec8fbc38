"""Host-side helpers: synthetic scenes."""
