"""Deployments: how a configuration holds its tables and serves a request,
one file each, found by the configuration's ``deployment.kind``."""
