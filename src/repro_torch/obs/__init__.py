"""Port of `repro.obs`."""
