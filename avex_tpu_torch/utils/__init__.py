"""Helpers of the port: checkpoint loading, experiment records and logging."""
