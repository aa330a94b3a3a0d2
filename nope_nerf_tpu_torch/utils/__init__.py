"""Host-side output utilities of the port (numpy + PIL): the MJPEG-in-MP4
video muxer and the camera-frustum PLY exporter."""
