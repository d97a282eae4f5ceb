"""Port of `repro.persistence`."""
