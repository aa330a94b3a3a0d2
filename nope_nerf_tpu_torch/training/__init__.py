"""Training step, schedule and loop of the port."""
