"""Compute functions over DeviceColumns."""
