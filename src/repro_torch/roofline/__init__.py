"""The three-term roofline over the dry-run's records."""
