"""Models that the port proves end to end."""
