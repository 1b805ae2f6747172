"""Placement of host blocks on the device for the streaming engine."""
