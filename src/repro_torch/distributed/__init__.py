"""Distributed-training pieces of the port: gradient compression and the
compressed all-reduce over a process group (``compression``), and the
sharding rules with their DTensor layouts (``sharding``)."""
