"""Chunk substrate, sources, vertex tables and the stream API."""
