"""Port of `repro.serving`."""
