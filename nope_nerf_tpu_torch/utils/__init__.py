"""Host-side utilities of the port (numpy + PIL): the MJPEG-in-MP4 video
muxer and video writer, the camera-frustum PLY exporter, and the synthetic
teacher scene."""
