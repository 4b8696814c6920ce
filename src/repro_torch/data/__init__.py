"""Offline datasets of the port (numpy; see :mod:`.datasets`)."""
