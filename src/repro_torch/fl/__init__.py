"""Federated round loop of the port: clients, backends, runtime, server."""
