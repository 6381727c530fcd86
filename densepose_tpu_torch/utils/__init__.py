"""Host utilities: path resolution with a download cache, and timers."""
