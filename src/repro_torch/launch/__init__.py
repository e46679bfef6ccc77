"""Launchers: the solve CLI."""
