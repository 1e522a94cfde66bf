"""Distributed-training pieces of the port (one device): gradient
compression (``compression``)."""
