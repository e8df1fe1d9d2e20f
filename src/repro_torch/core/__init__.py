"""Compression core of the port: flat layout, hist engine, channel."""
