"""Port of `repro.core`."""
