"""Model wrappers of the port: registry, factory, loading and BEATs."""
