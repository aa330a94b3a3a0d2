"""Camera geometry of the port: SO(3)/SE(3) and ray math."""
