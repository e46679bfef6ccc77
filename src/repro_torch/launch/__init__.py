"""Launchers: the solve CLI, the LM serving CLI (``serve lm``) and the
recsys and LM serving steps."""
