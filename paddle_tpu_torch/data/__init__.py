"""Input pipeline of the port: segment packing (``decorator``)."""

from . import decorator  # noqa: F401
