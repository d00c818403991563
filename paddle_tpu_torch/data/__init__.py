"""Input pipeline of the port: batching, length pooling and segment
packing (``decorator``)."""

from . import decorator  # noqa: F401
