"""Public data of the port: the official model tables."""
