"""Point-cloud file formats."""
