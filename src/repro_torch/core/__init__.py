"""Crowd-model primitives shared by the port's engines."""
