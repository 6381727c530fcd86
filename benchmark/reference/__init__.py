"""The plain float32 reference of the served models (imports nothing of the program)."""
