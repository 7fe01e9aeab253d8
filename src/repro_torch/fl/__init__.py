"""Federated round loop of the port: clients, the execution spec and
backends, runtime, server."""
