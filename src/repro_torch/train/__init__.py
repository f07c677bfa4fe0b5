"""The train step (port of ``repro/train``)."""
