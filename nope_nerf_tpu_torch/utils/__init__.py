"""Host-side utilities of the port (numpy + PIL): the MJPEG-in-MP4 video
muxer and video writer, the camera-frustum PLY exporter, the synthetic
teacher scene, and the metrics logger and rays/s counter."""
