"""The model substrate of the port: the hybrid (zamba2) family so far."""
