"""Renderer, Phong preview, encoding, interpolation and Chamfer ops of the
port."""
