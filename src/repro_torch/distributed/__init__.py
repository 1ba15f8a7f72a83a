"""Distributed SpGEMM: plan IR, collectives, executors, model registry and
the compile-once runtime (the port of ``repro.distributed``)."""
