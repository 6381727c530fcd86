"""Host utilities: path resolution with a download cache, timers, and a
string -> object registry."""
