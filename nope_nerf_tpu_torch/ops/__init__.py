"""Renderer, encoding, interpolation and Chamfer ops of the port."""
