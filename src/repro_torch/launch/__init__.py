"""Launchers: the solve CLI and the recsys serving steps."""
