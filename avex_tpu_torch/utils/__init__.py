"""Checkpoint loading helpers of the port."""
