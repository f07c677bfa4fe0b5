"""Fault tolerance and elastic re-meshing (port of ``repro.runtime``)."""
