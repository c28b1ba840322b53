"""Utilities of the port: profiling hooks (``utils.profiling``)."""
