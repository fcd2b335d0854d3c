"""Serving: cokriging over a cached factor (``cokrige_service``)."""
