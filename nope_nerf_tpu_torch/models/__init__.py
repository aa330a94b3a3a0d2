"""Learnable parameter groups of the port: NeRF field, poses, focal, distortion."""
