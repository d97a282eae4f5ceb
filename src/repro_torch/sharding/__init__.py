"""Sharding rules and activation-constraint hooks of the port."""
