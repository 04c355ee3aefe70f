"""Serving steps of the port (``serve_step``)."""
