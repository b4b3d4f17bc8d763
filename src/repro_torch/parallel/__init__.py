"""Sharding rules and the activation-sharding context on
``torch.distributed`` DTensors (the port of ``repro.parallel``)."""
