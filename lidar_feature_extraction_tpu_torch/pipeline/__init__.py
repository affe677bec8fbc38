"""End-to-end pipelines built from the ops."""
