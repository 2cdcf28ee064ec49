"""Small helpers shared by the training entry."""
