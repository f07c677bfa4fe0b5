"""Decoder models of the port (dense attn stacks)."""
